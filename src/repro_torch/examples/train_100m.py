"""End-to-end training example, the counterpart of
``examples/train_100m.py``: a ~100M-parameter llama-style model trained on
synthetic data through the port's launcher (``repro_torch.launch.train``:
the training path, AdamW, the resumable pipeline, async checkpoints).

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 20 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_100m \\
      --ckpt-dir <dir>

``--device`` defaults to the card; ``--ckpt-dir`` (none by default) saves
every 100 steps and at the end, and resumes from the latest checkpoint.
"""
import argparse

from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as train_launcher

CONFIG_100M = ArchConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=6, d_ff=2048, vocab=32000, rope_theta=10000.0,
    tie_embeddings=True, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)
    print(f"training {CONFIG_100M.name}")
    tcfg = TrainConfig(lr=3e-4)
    return train_launcher.run(
        CONFIG_100M, tcfg, SyntheticTokens(CONFIG_100M, 8, 256, tcfg.seed),
        steps=args.steps, device=args.device, ckpt_dir=args.ckpt_dir,
        ckpt_every=100, log_every=10)


if __name__ == "__main__":
    main()
