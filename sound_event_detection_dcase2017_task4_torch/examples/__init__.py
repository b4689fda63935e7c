"""The port's examples: counterparts of the repository's ``examples/``,
under the same names, on the port's API.

    python -m sound_event_detection_dcase2017_task4_torch.examples.minimal_train
    python -m sound_event_detection_dcase2017_task4_torch.examples.streaming_live --workspace=$WS
"""
