"""Minimal library-API example: train a SED model and decode events.

Counterpart of the repository's ``examples/minimal_train.py``. Runs
self-contained on the card (tiny synthetic data, 1 s clips, the
hand-written log-mel kernel) in seconds:

    python -m sound_event_detection_dcase2017_task4_torch.examples.minimal_train
"""

import numpy as np
import torch

import sound_event_detection_dcase2017_task4_torch as sedt


def main(device=None, steps: int = 30):
    """Train ``steps`` steps on ``device`` (``None``: the card) and print
    the first clips' events; returns them."""
    cfg = sedt.Config(clip_samples=32000)           # 1 s clips for speed
    clips = sedt.data.make_synthetic_dataset(32, cfg, seed=0)
    waves = np.stack([c.waveform for c in clips])
    targets = np.stack([c.weak_target for c in clips])

    # model + fused frontend (the CUDA kernel on the card) + train step
    model = sedt.get_model("Cnn_9layers_Gru_FrameAtt",
                           generator=torch.Generator().manual_seed(0))
    frontend = sedt.make_logmel_fn(cfg)
    state = sedt.train.create_train_state(model, cfg, learning_rate=1e-3,
                                          device=device)
    step = sedt.train.make_train_step(model, state, frontend=frontend,
                                      mixup_alpha=1.0)

    for i in range(steps):
        metrics = step(waves, targets)
        if i % 10 == 0:
            print(f"step {i}: loss {float(metrics['loss']):.4f}")

    # inference → SED events
    eval_step = sedt.train.make_eval_step(model, frontend=frontend)
    out = eval_step(waves[:4])
    events = sedt.sed.frame_prediction_to_event_prediction(
        out["framewise_output"].float().cpu().numpy(),
        {"sed_high_threshold": 0.3, "sed_low_threshold": 0.15,
         "n_smooth": 10, "n_salt": 10})
    for i, evs in enumerate(events):
        print(f"clip {i}: {evs[:3]}")
    return events


if __name__ == "__main__":
    main()
