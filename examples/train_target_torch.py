"""End-to-end training driver of the PyTorch port: train the ~100M-
parameter dense target (``target-100m``: 12L, d=768, 12H, vocab 8K) on
the synthetic corpus for a few hundred steps with AdamW + cosine
schedule + grad clipping + checkpointing.  The counterpart of
``examples/train_target.py``, with the same flags plus ``--device``.

Run:  PYTHONPATH=src python examples/train_target_torch.py --steps 300
      [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticCorpus, batch_iterator  # noqa: E402
from repro_torch.train import Trainer, TrainConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="target-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt", default="results/artifacts_torch/target100m.npz")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, order=1,
                             branching=4, seed=0)
    if os.path.dirname(args.ckpt):
        os.makedirs(os.path.dirname(args.ckpt), exist_ok=True)
    tr = Trainer(cfg, TrainConfig(total_steps=args.steps, warmup=20,
                                  log_every=10, ckpt_path=args.ckpt,
                                  ckpt_every=100), device=args.device)
    res = tr.fit(batch_iterator(corpus, batch=args.batch,
                                seq_len=args.seq_len), steps=args.steps)
    print(f"final loss: {res['final_loss']:.4f} "
          f"(checkpoint -> {args.ckpt})")
    return res


if __name__ == "__main__":
    main()
