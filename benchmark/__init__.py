"""The benchmark of the PyTorch/CUDA port (``sound_event_detection_dcase2017_task4_torch``).

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
"""
