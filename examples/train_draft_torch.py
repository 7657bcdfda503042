"""Draft-module training of the PyTorch port with the EAGLE-3
training-time-test loss (paper eq. (5)) + YARN long-context adaptation
(paper App. A, Fig. 8).

Trains two drafts on a trained tiny target: one at base context, one with
YARN scaling for longer contexts, and prints the TTT loss curves (the
small-scale analogue of Fig. 8).  The counterpart of
``examples/train_draft.py``, with the same flags plus ``--device`` and
the trained pair's step counts (``--target-steps`` / ``--draft-steps``,
as in ``examples/quickstart_torch.py``).

Run:  PYTHONPATH=src python examples/train_draft_torch.py --steps 150
      [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.artifacts import corpus_for, get_trained_pair  # noqa: E402
from repro_torch.data import batch_iterator  # noqa: E402
from repro_torch.train import DraftTrainConfig, DraftTrainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--seq-len", type=int, default=192)
    ap.add_argument("--yarn", type=float, default=4.0,
                    help="YARN scaling factor for the long-context draft")
    ap.add_argument("--target-steps", type=int, default=200)
    ap.add_argument("--draft-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg, dcfg, params, _ = get_trained_pair(
        "tiny-dense", target_steps=args.target_steps,
        draft_steps=args.draft_steps, device=args.device)
    corpus = corpus_for(cfg)

    print("== base-context draft (TTT loss, eq. 5) ==")
    base = DraftTrainer(cfg, dcfg, params,
                        DraftTrainConfig(total_steps=args.steps, warmup=10,
                                         log_every=25), device=args.device)
    rb = base.fit(batch_iterator(corpus, batch=8, seq_len=args.seq_len,
                                 seed=11), steps=args.steps)

    print(f"\n== YARN x{args.yarn} long-context draft (App. A) ==")
    cfg_yarn = cfg.replace(yarn_factor=args.yarn,
                           yarn_orig_len=args.seq_len)
    yarn = DraftTrainer(cfg_yarn, dcfg, params,
                        DraftTrainConfig(total_steps=args.steps, warmup=10,
                                         log_every=25), device=args.device)
    ry = yarn.fit(batch_iterator(corpus, batch=8, seq_len=args.seq_len,
                                 seed=13), steps=args.steps)

    print("\nTTT loss curves (step, L_total, L0):")
    for tag, hist in [("base", rb["history"]), ("yarn", ry["history"])]:
        pts = [(h["step"], round(h["loss"], 3), round(h["ttt_loss_0"], 3))
               for h in hist]
        print(f"  {tag}: {pts}")
    return dict(base=rb, yarn=ry)


if __name__ == "__main__":
    main()
