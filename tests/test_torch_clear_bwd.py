"""K1's backward twin against the JAX package's ``_fused_clear_bwd``, the
CPU autograd path's launch counters, label dtypes, and the ctypes bindings
of the fused-loss wrappers against the CUDA sources they load (nothing
compiles here, so this is the guard against a stale binding)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.ops.pallas import fused_loss as JF
from clearvae_torch.ops.kernels import _build
from clearvae_torch.ops.kernels import fused_loss as FL


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latents(b, z, seed):
    rs = np.random.RandomState(seed)
    mats = [(rs.randn(b, z) * s).astype(np.float32) for s in (1, .3, 1, .3)]
    return mats, rs.randint(0, 10, b)


@pytest.fixture(autouse=True)
def _zero_counters():
    FL.reset_launches()
    yield
    assert all(v == 0 for v in FL.LAUNCHES.values()), FL.LAUNCHES


@pytest.mark.parametrize("b,z,ps", [(128, 8, True), (100, 7, False)])
def test_clear_latent_bwd_plain_matches_jax(b, z, ps):
    mats, lbl = _latents(b, z, 3 * b + z)
    jargs = [jnp.asarray(m) for m in mats]
    _, res = JF._fused_clear_fwd(*jargs, jnp.asarray(lbl), 0.1, ps)
    g = np.random.RandomState(b).randn(4).astype(np.float32)
    ref = JF._fused_clear_bwd(0.1, ps, res, tuple(jnp.float32(v) for v in g))
    got = FL.clear_latent_bwd_plain(*(torch.as_tensor(np.array(r))
                                      for r in res), torch.as_tensor(g))
    for a, r in zip(got, ref[:4]):
        r = np.asarray(r)
        # 1 - exp(lv) cancels near lv = 0: an ulp of exp is the floor there
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-6,
                                   atol=1e-7 * float(np.abs(r).max()))


def test_cpu_autograd_path_launches_nothing():
    mats, lbl = _latents(64, 8, 5)
    args = [torch.tensor(m, requires_grad=True) for m in mats]
    terms = FL.fused_clear_latent_loss(*args, torch.as_tensor(lbl),
                                       temperature=0.1, ps=True)
    assert all(v == 0 for v in FL.LAUNCHES.values())
    sum(w * t for w, t in zip((0.7, 1.3, 0.11, 0.05), terms)).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in args)
    # the fixture checks that the backward launched nothing either


def test_int32_and_int64_labels_give_the_same_terms():
    mats, lbl = _latents(48, 8, 9)
    ts = [torch.as_tensor(m) for m in mats]
    a = FL.clear_latent_fwdgrad(*ts, torch.as_tensor(lbl, dtype=torch.int64),
                                0.1, True)
    b = FL.clear_latent_fwdgrad(*ts, torch.as_tensor(lbl, dtype=torch.int32),
                                0.1, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _extern_c_functions(path):
    """{name: number of parameters} of the extern "C" functions of a .cu."""
    src = open(path).read()
    blocks = re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', src, re.S)
    blocks += re.findall(r'extern "C" (int \w+\([^)]*\))', src)
    out = {}
    for block in blocks:
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
            out[name] = len([p for p in params.split(",") if p.strip()])
    return out


@pytest.mark.parametrize("source", sorted(FL._SIGNATURES))
def test_bindings_name_extern_c_functions_of_their_source(source):
    funcs = _extern_c_functions(os.path.join(_build.CSRC, source + ".cu"))
    for name, argtypes in FL._SIGNATURES[source].items():
        assert name in funcs, f"{name} is not an extern \"C\" function of {source}.cu"
        assert funcs[name] == len(argtypes), (name, funcs[name], len(argtypes))
    assert source in _build.sources()
