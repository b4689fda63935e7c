"""Ops: host DSP constants, the plain PyTorch log-mel, the hand-written CUDA
kernels (the log-mel frontend, train-mode BatchNorm, HTS-AT's window
attention) and their builder."""
