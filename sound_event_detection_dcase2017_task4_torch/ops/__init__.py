"""Frontend ops: host DSP constants, the plain PyTorch log-mel, the CUDA kernel."""
