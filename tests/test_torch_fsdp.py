"""FSDP training in the PyTorch port (``launch.steps.make_train_step(
grad_shardings=param_specs(ShardingRules(mesh, fsdp=True), params))``),
on the CPU against the JAX package's unsharded ``make_train_step``:
``tiny-dense`` in fp32, two steps from the same init on the same
batches; and the MoE targets ``granite-moe-1b-a400m`` and ``dbrx-132b``
reduced (4 experts, top-2), whose routing and aux loss run over the
whole batch.

* On (2, 1) and (2, 2) meshes of CPU devices: the loss and every
  parameter within 2e-4 of JAX's after each step; the caller's parameter
  tensors are updated in place and left without ``requires_grad``.
* The moments live per mesh device as the specs cut them: each device's
  moments are ``shard_leaf`` of JAX's whole moments (rtol 1e-4, atol
  1e-6), a leaf that no split divides stays whole on every device, and
  the split leaves hold a slice.
* A spec tree that does not match the parameters, or one that carries no
  mesh, raises ValueError.
* MoE, the router scaled by 4 (capacity binds: pairs are dropped): one
  dispatch group (4 x 64 tokens) on (2, 1), where each shard alone
  would get half the capacity; groups that span shards with a zero-padded
  last group (4 x 300 tokens, groups of 1024) on (4, 1) and (2, 2) (the
  experts also split over ``model``), and ``dbrx-132b`` on (2, 1).  The
  loss and every parameter within 2e-4 of JAX's after each step, the
  moments as above, and the drops (``blocks.MOE_DROPS``) of the FSDP
  steps equal to the port's unsharded steps', which drop pairs.
* Without JAX: ``api.sharded_train_loss`` over the shards equals one
  ``train_loss`` over the whole batch (lm loss, aux loss and gradients
  within 1e-6 of each value's magnitude).
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
from repro_torch.models import blocks as tbk
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


def _check_moments(tcfg, mesh, specs, opt, jmu, jnu):
    """One moment tree per mesh device, each the specs' slice of JAX's
    whole moments; some leaves split, some whole."""
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


# ---------------------------------------------------------------------------
# MoE targets: the whole batch's routing and aux loss
# ---------------------------------------------------------------------------

MOE_ARCHS = {"granite": "granite-moe-1b-a400m", "dbrx": "dbrx-132b"}
ROUTER_SCALE = 4.0


@pytest.fixture(scope="module")
def moe_models():
    """Per arch: the reduced fp32 configs and the JAX init as numpy, the
    router scaled by ROUTER_SCALE so that routing is decisive."""
    out = {}
    for key, arch in MOE_ARCHS.items():
        cfg = jcfgs.get_config(arch).reduced().replace(
            dtype="float32", param_dtype="float32")
        tcfg = tcfgs.get_config(arch).reduced().replace(
            dtype="float32", param_dtype="float32")
        np_params = jax.tree_util.tree_map_with_path(
            lambda path, a: np.asarray(a) * (
                ROUTER_SCALE if "router" in jax.tree_util.keystr(path)
                else 1), jax.jit(lambda k: japi.init_params(cfg, k))(
                    jax.random.PRNGKey(0)))
        out[key] = (cfg, tcfg, np_params)
    return out


@pytest.fixture(scope="module")
def moe_jax_runs(moe_models):
    """Memoised: the reference's two unsharded steps for (arch, batch
    shape), as ``jax_run``'s."""
    runs = {}

    def get(key, shape):
        if (key, shape) not in runs:
            cfg, _, np_params = moe_models[key]
            rng = np.random.default_rng(61)
            batches = [rng.integers(0, cfg.vocab_size, shape).astype(
                np.int32) for _ in range(2)]
            jstep = jax.jit(jsteps.make_train_step(cfg))
            jp = jax.tree_util.tree_map(jnp.asarray, np_params)
            jo = jopt.adamw_init(jp)
            out = []
            for toks in batches:
                jp, jo, jl = jstep(jp, jo, jnp.asarray(toks), None)
                out.append((float(jl),
                            jax.tree_util.tree_map(np.asarray, jp),
                            jax.tree_util.tree_map(np.asarray, jo.mu),
                            jax.tree_util.tree_map(np.asarray, jo.nu)))
            runs[key, shape] = batches, out
        return runs[key, shape]
    return get


def _port_steps(tcfg, np_params, batches, specs_for=None):
    """Two port steps (FSDP when ``specs_for`` gives the spec tree of the
    params): (params, opt, losses, drops a step)."""
    params = params_from_numpy(tcfg, np_params, device="cpu")
    specs = None if specs_for is None else specs_for(params)
    step = tsteps.make_train_step(tcfg, grad_shardings=specs)
    opt = topt.adamw_init(params)
    losses, drops = [], []
    tbk.MOE_DROPS = torch.zeros((), dtype=torch.long)
    try:
        for toks in batches:
            params, opt, loss = step(params, opt, torch.from_numpy(toks),
                                     None)
            losses.append(float(loss))
            drops.append(int(tbk.MOE_DROPS))
            tbk.MOE_DROPS.zero_()
    finally:
        tbk.MOE_DROPS = None
    return params, specs, opt, losses, drops


@pytest.mark.parametrize("key,batch,shape", [
    ("granite", (4, 65), (2, 1)),
    ("granite", (4, 301), (4, 1)),
    ("granite", (4, 301), (2, 2)),
    ("dbrx", (4, 301), (2, 1))],
    ids=["granite-one-group-2x1", "granite-spanning-4x1",
         "granite-spanning-2x2", "dbrx-spanning-2x1"])
def test_fsdp_moe_step_matches_jax(moe_models, moe_jax_runs, key, batch,
                                   shape):
    """4 x 64 tokens: one group of 256, capacity 160 per expert (80 for
    a shard alone).  4 x 300: groups [0, 1024) over every shard and
    [1024, 2048) holding the last 176 tokens and 848 zero rows."""
    _, tcfg, np_params = moe_models[key]
    batches, want = moe_jax_runs(key, batch)
    mesh = _mesh(shape)
    _, _, _, _, base_drops = _port_steps(tcfg, np_params, batches)
    assert all(d > 0 for d in base_drops), "capacity must bind"
    params, specs, opt, losses, drops = _port_steps(
        tcfg, np_params, batches, lambda p: tsh.param_specs(
            tsh.ShardingRules(mesh, fsdp=True), p))
    assert drops == base_drops
    for loss, (jl, _, _, _) in zip(losses, want):
        assert abs(loss - jl) < 2e-4
    jl, jp, jmu, jnu = want[-1]
    got = jax.tree_util.tree_leaves(params_to_numpy(tcfg, params))
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        got, jax.tree_util.tree_leaves(jp))) < 2e-4
    _check_moments(tcfg, mesh, specs, opt, jmu, jnu)


@pytest.mark.parametrize("batch,shards", [((4, 65), 2), ((4, 301), 4),
                                          ((2, 1301), 2)],
                         ids=["one-group", "spanning", "three-groups"])
def test_sharded_train_loss_is_the_whole_batch_loss(moe_models, batch,
                                                    shards):
    """The port alone: the shards' routing contexts summed give one
    ``train_loss`` over the whole batch.  (2, 1301): 2600 tokens in three
    groups, the second split between the shards."""
    _, tcfg, np_params = moe_models["granite"]
    toks = torch.from_numpy(np.random.default_rng(62).integers(
        0, tcfg.vocab_size, batch))
    rows = batch[0] // shards
    out = []
    for sharded in (False, True):
        params = params_from_numpy(tcfg, np_params, device="cpu")
        leaves = topt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if sharded:
            loss, m = tapi.sharded_train_loss(tcfg, [
                (params, toks[d * rows:(d + 1) * rows], None)
                for d in range(shards)])
        else:
            loss, m = tapi.train_loss(tcfg, params, toks)
        grads = torch.autograd.grad(loss, leaves)
        out.append((float(m["lm_loss"].detach()),
                    float(m["aux_loss"].detach()), grads))
    (lm, aux, grads), (s_lm, s_aux, s_grads) = out
    assert abs(s_lm - lm) <= 1e-6 * abs(lm)
    assert abs(s_aux - aux) <= 1e-6 * abs(aux)
    for a, b in zip(s_grads, grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
