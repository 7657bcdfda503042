"""The port's config and utility helpers against the reference's: each
registry id's ``param_count`` and ``active_param_count`` (and their
``reduced()`` variants'), ``list_archs``, and ``repro/utils/misc.py``'s
``cdiv``, ``round_up``, ``tree_size_bytes`` and ``human_bytes``."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import api as japi
from repro.utils import misc as jmisc
from repro_torch import configs as tcfgs
from repro_torch import utils as tutils
from repro_torch.convert import params_from_numpy

ARCHS = jcfgs.list_archs()


def test_list_archs_is_the_reference_registry():
    assert tcfgs.list_archs() == ARCHS and len(ARCHS) == 14


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for reduce in (False, True):
        j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert 0 < t.active_param_count() <= t.param_count()


def test_rounding_and_bytes_match_reference():
    for a in range(-40, 200, 7):
        for b in (1, 2, 3, 16, 128):
            assert tutils.cdiv(a, b) == jmisc.cdiv(a, b)
            assert tutils.round_up(a, b) == jmisc.round_up(a, b)
    for n in (0, 1, 1023, 1024, 5e6, -3e9, 2.5e12, 7e15, 1e18):
        assert tutils.human_bytes(n) == jmisc.human_bytes(n)


def test_tree_size_bytes_matches_reference():
    cfg = jcfgs.get_config("tiny-dense")
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    want = jmisc.tree_size_bytes(params)
    assert tutils.tree_size_bytes(np_params) == want
    tp = params_from_numpy(tcfgs.get_config("tiny-dense"), np_params,
                           device="cpu")
    assert tutils.tree_size_bytes(tp) == want
    mixed = {"a": [torch.zeros(3, 4, dtype=torch.bfloat16),
                   np.zeros((5,), np.int64)], "b": (torch.ones(2),),
             "c": 7, "d": None}
    assert tutils.tree_size_bytes(mixed) == 24 + 40 + 8
