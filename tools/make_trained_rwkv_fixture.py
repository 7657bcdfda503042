"""Write the trained reduced ``rwkv6-3b`` pair that
``tests/test_torch_trained_rwkv.py`` runs, as a test fixture.

The pair is the reference's own recipe, trained here on the CPU:
``repro.artifacts.get_trained_pair("rwkv6-3b")`` (the reduced config, 200
target and 150 draft steps on the synthetic corpus; no download) into a
temporary directory.  The reference's ``.npz`` checkpoints do not load
back bf16 weights, so this writes its own file: every leaf under its
``jax.tree_util.keystr`` path (``t`` the target's, ``d`` the draft's),
bf16 leaves as their raw 16-bit patterns (``uint16``), the others as
they are.  ``load_pair`` reads it back onto the reference's templates,
bit for bit.

Run:  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_trained_rwkv_fixture.py
      [--out tests/data/trained_rwkv6_pair.npz]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "trained_rwkv6_pair.npz")
ARCH = "rwkv6-3b"


def _flat(tree):
    import jax
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _encode(prefix: str, tree) -> dict:
    import jax.numpy as jnp
    out = {}
    for key, leaf in _flat(tree):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[f"{prefix}{key}|bf16"] = a.view(np.uint16)
        else:
            out[f"{prefix}{key}"] = a
    return out


def _decode(data, prefix: str, template):
    """The leaves of ``data`` under ``prefix`` in ``template``'s tree."""
    import jax
    import jax.numpy as jnp
    leaves = []
    for key, tmpl in _flat(template):
        if f"{prefix}{key}|bf16" in data:
            a = data[f"{prefix}{key}|bf16"].view(jnp.bfloat16)
        else:
            a = data[f"{prefix}{key}"]
        assert a.shape == tmpl.shape, (key, a.shape, tmpl.shape)
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves)


def load_pair(path: str = FIXTURE):
    """(cfg, dcfg, target params, draft params) as
    ``get_trained_pair("rwkv6-3b")`` returned them when the fixture was
    written: the reference's reduced config, its default draft config,
    and the trained trees (jax arrays, bf16 where trained so)."""
    import jax
    from repro import artifacts
    from repro.configs import get_config
    from repro.core.draft import init_draft_params
    from repro.models import api
    cfg = get_config(ARCH).reduced()
    dcfg = artifacts.DEFAULT_DCFG
    tmpl = api.init_params(cfg, jax.random.PRNGKey(0))
    dtmpl = init_draft_params(cfg, dcfg, jax.random.PRNGKey(1))
    with np.load(path) as data:
        return (cfg, dcfg, _decode(data, "t", tmpl),
                _decode(data, "d", dtmpl))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro import artifacts
    with tempfile.TemporaryDirectory() as tmp:
        artifacts.ART_DIR = tmp
        cfg, dcfg, params, dparams = artifacts.get_trained_pair(ARCH)
    assert dcfg == artifacts.DEFAULT_DCFG
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **_encode("t", params),
                        **_encode("d", dparams))
    print(f"{cfg.name}: wrote {args.out} "
          f"({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
