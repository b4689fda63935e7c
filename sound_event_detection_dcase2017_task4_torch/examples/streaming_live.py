"""Live-stream SED demo: feed audio chunk-by-chunk, print events as they
become final.

Counterpart of the repository's ``examples/streaming_live.py``. Simulates
a microphone loop by slicing a generated recording into ragged chunks; in
production, replace the loop body with your audio callback. Events print
the moment they are decode-stable, each exactly once, with absolute
timestamps, the same as the offline ``predict_long`` path gives on the
same audio (``tests/test_torch_serving.py``).

Run on the card (after training something, see ``minimal_train`` or
``runme_torch.sh``; a workspace the JAX CLI trained serves too):

    python -m sound_event_detection_dcase2017_task4_torch.examples.streaming_live \
        --workspace=$WS --model_type=Cnn_9layers_Gru_FrameAtt \
        --run_config="loss_type=clip_bce/augmentation=mixup/batch_size=32"
"""

import argparse

import numpy as np

import sound_event_detection_dcase2017_task4_torch as sedt


def live_audio(seconds: float, sr: int) -> np.ndarray:
    """The simulated recording: background noise + intermittent tones."""
    rng = np.random.RandomState(0)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    return (0.05 * rng.randn(n)
            + 0.5 * np.sin(2 * np.pi * 600 * t)
            * (np.sin(2 * np.pi * 0.23 * t) > 0.6)).astype(np.float32)


def main(argv=None, device=None) -> list:
    """Stream on ``device`` (``None``: the card); returns the printed
    lines."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workspace", required=True)
    p.add_argument("--model_type", default="Cnn_9layers_Gru_FrameAtt")
    p.add_argument("--run_config",
                   default="loss_type=clip_bce/augmentation=mixup/"
                           "batch_size=32")
    p.add_argument("--seconds", type=float, default=30.0,
                   help="length of the simulated live recording")
    p.add_argument("--chunk_ms", type=int, default=250,
                   help="simulated audio-callback chunk size")
    args = p.parse_args(argv)

    predictor = sedt.Predictor.from_workspace(
        args.workspace, args.model_type, args.run_config, device=device)
    detector = sedt.StreamingDetector(predictor)

    sr = predictor.cfg.sample_rate
    audio = live_audio(args.seconds, sr)
    n = len(audio)
    lines = []
    chunk = int(sr * args.chunk_ms / 1000)
    for pos in range(0, n, chunk):
        for onset, offset, label in detector.feed(audio[pos : pos + chunk]):
            lines.append(f"[live {pos / sr:6.2f}s] {onset:7.2f}-{offset:7.2f}s "
                         f"{label}")
            print(lines[-1])
    for onset, offset, label in detector.flush():
        lines.append(f"[flush       ] {onset:7.2f}-{offset:7.2f}s {label}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
