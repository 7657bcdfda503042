"""FSDP training in the PyTorch port (``launch.steps.make_train_step(
grad_shardings=param_specs(ShardingRules(mesh, fsdp=True), params))``),
on the CPU against the JAX package's unsharded ``make_train_step``:
``tiny-dense`` in fp32, two steps from the same init on the same
batches.

* On (2, 1) and (2, 2) meshes of CPU devices: the loss and every
  parameter within 2e-4 of JAX's after each step; the caller's parameter
  tensors are updated in place and left without ``requires_grad``.
* The moments live per mesh device as the specs cut them: each device's
  moments are ``shard_leaf`` of JAX's whole moments (rtol 1e-4, atol
  1e-6), a leaf that no split divides stays whole on every device, and
  the split leaves hold a slice.
* A spec tree that does not match the parameters, or one that carries no
  mesh, raises ValueError; an MoE target raises NotImplementedError
  naming its ROADMAP item.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as topt


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: japi.init_params(cfg, k))(jax.random.PRNGKey(0)))
    return cfg, tcfg, np_params


@pytest.fixture(scope="module")
def jax_run(tiny):
    """The reference's two unsharded steps: (losses, params, moments)
    after each step, as numpy trees."""
    cfg, _, np_params = tiny
    rng = np.random.default_rng(60)
    batches = [rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
               for _ in range(2)]
    jstep = jax.jit(jsteps.make_train_step(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jo = jopt.adamw_init(jp)
    out = []
    for toks in batches:
        jp, jo, jl = jstep(jp, jo, jnp.asarray(toks), None)
        out.append((float(jl), jax.tree_util.tree_map(np.asarray, jp),
                    jax.tree_util.tree_map(np.asarray, jo.mu),
                    jax.tree_util.tree_map(np.asarray, jo.nu)))
    return batches, out


def _mesh(shape):
    return tsh.DeviceMesh(shape, devices=["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_fsdp_step_matches_jax(tiny, jax_run, shape):
    cfg, tcfg, np_params = tiny
    batches, want = jax_run
    mesh = _mesh(shape)
    params = params_from_numpy(tcfg, np_params, device="cpu")
    specs = tsh.param_specs(tsh.ShardingRules(mesh, fsdp=True), params)
    step = tsteps.make_train_step(tcfg, grad_shardings=specs)
    opt = topt.adamw_init(params)
    ptr = params["embed"].data_ptr()
    for toks, (jl, jp, jmu, jnu) in zip(batches, want):
        out, opt, loss = step(params, opt, torch.from_numpy(toks), None)
        assert out is params
        assert abs(float(loss) - jl) < 2e-4
        got = jax.tree_util.tree_leaves(params_to_numpy(tcfg, params))
        assert max(float(np.abs(a - b).max()) for a, b in zip(
            got, jax.tree_util.tree_leaves(jp))) < 2e-4
    assert params["embed"].data_ptr() == ptr
    assert not any(p.requires_grad for p in topt.tree_leaves(params))
    # the moments: one tree per mesh device, each the specs' slice
    assert isinstance(opt.mu, topt.ShardedMoments) and opt.step == 2
    assert len(opt.mu) == len(opt.nu) == mesh.size
    sps = tsh.spec_leaves(specs)
    split = whole = 0
    for jm, mom in ((jmu, opt.mu), (jnu, opt.nu)):
        full = topt.tree_leaves(params_from_numpy(tcfg, jm, device="cpu"))
        for c in range(mesh.size):
            co = mesh.coords(c)
            for f, sp, m in zip(full, sps, topt.tree_leaves(mom[c])):
                piece = tsh.shard_leaf(f, sp, mesh, co)
                assert m.shape == piece.shape
                np.testing.assert_allclose(m.numpy(), piece.numpy(),
                                           rtol=1e-4, atol=1e-6)
                if m.shape == f.shape:
                    whole += 1
                else:
                    split += 1
    assert split > 0 and whole > 0


def test_fsdp_refuses_a_mismatched_spec_tree(tiny):
    _, tcfg, np_params = tiny
    mesh = _mesh((2, 1))
    params = params_from_numpy(tcfg, np_params, device="cpu")
    specs = tsh.param_specs(tsh.ShardingRules(mesh, fsdp=True), params)
    toks = torch.zeros((2, 9), dtype=torch.long)
    bad = tsh.ParamSpecs({k: v for k, v in specs.items() if k != "embed"},
                         specs.rules)
    with pytest.raises(ValueError, match="spec tree"):
        tsteps.make_train_step(tcfg, grad_shardings=bad)(
            params, topt.adamw_init(params), toks, None)
    with pytest.raises(ValueError, match="param_specs"):
        tsteps.make_train_step(tcfg, grad_shardings=dict(specs))
    with pytest.raises(ValueError, match="data shards"):
        tsteps.make_train_step(tcfg, grad_shardings=specs)(
            params, topt.adamw_init(params), toks[:1], None)
    moe = tcfgs.get_config("granite-moe-1b-a400m").reduced()
    mparams = tapi.init_params(moe, seed=0, device="cpu")
    mspecs = tsh.param_specs(tsh.ShardingRules(mesh, fsdp=True), mparams)
    with pytest.raises(NotImplementedError, match="Multi-GPU, part 4"):
        tsteps.make_train_step(moe, grad_shardings=mspecs)
