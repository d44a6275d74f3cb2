"""The port's runtime set-up and the repaired trainer option, on the CPU:
every runner whose JAX counterpart takes the device lock and the
compilation cache takes the port's lock and leaves TF32 off before it
touches the device (illustrate and analyze, as in JAX, neither), and so
do the trainers' ``fit``; the single-GPU-process lock refuses a second
process and names the holder, and its escape hatch skips it;
``HierarchicalVAETrainer(eval_evidence_acc=...)`` picks the default eval step as JAX's does, its ``evaluate`` equal to
JAX's for both values."""

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.data.common import ArrayDataset as JArrayDataset
from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.trainers import HierarchicalVAETrainer as JHTrainer
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.models.vae import VAE as TVAE
from clearvae_torch.train.trainers import HierarchicalVAETrainer, adam
from clearvae_torch.utils import lock as L
from test_torch_scan_defaults import _eps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the runners whose JAX counterparts call acquire_tpu_lock() and
# enable_compilation_cache() at the top of main
LOCKED = ["styledmnist_downstream", "mig_expr", "mig_expr_celeba",
          "celeba_downstream", "pacs_downstream", "camelyon17_downstream",
          "chexpert_downstream", "demo", "mi_simulation"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on (PyTorch's default for cuDNN) for the test, and
    as they were afterwards."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


class _Stop(Exception):
    """Raised where a runner first resolves its device: its heavy work is
    not run."""


def _main_until_device(name, monkeypatch):
    """Run ``name``'s ``main`` until it resolves its device; returns how
    often it took the lock."""
    mod = importlib.import_module(f"clearvae_torch.experiments.{name}")
    calls = []
    monkeypatch.setattr(L, "acquire_gpu_lock",
                        lambda *a, **k: calls.append(a) or False)

    def stop(*_):
        raise _Stop
    monkeypatch.setattr(mod, "resolve_device", stop)
    with pytest.raises(_Stop):
        mod.main(["--device", "cpu"])
    return len(calls)


@pytest.mark.parametrize("name", LOCKED)
def test_runner_takes_the_lock_and_sets_fp32_before_the_device(
        name, monkeypatch, tf32_on):
    assert _main_until_device(name, monkeypatch) >= 1
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_illustrate_takes_no_lock(monkeypatch, tf32_on):
    assert _main_until_device("illustrate", monkeypatch) == 0
    assert torch.backends.cudnn.allow_tf32 is True


def test_analyze_takes_no_lock(monkeypatch, tf32_on, tmp_path):
    from clearvae_torch.experiments import analyze

    calls = []
    monkeypatch.setattr(L, "acquire_gpu_lock", lambda *a, **k: calls.append(a))
    res = {"baseline": {"acc": 0.5, "pr": {"overall": 0.4},
                        "roc": {"overall": 0.6}}}
    (tmp_path / "styledmnist-k1-0.json").write_text(json.dumps(res))
    df, _ = analyze.main(["--result_dir", str(tmp_path)])
    assert len(df) == 1 and calls == []
    assert torch.backends.cudnn.allow_tf32 is True


def _count_locks(monkeypatch):
    calls = []
    monkeypatch.setattr(L, "acquire_gpu_lock",
                        lambda *a, **k: calls.append(a) or False)
    return calls


@pytest.mark.parametrize("which", ["vae", "probe"])
def test_fit_takes_the_lock_and_sets_fp32_first(which, monkeypatch, tf32_on):
    """As JAX's ``fit`` takes its lock, the port's makes the runners' call
    before anything else, so a library user who trains without a runner
    also trains alone on the card with fp32 numerics (here ``fit`` then
    stops at its first argument check)."""
    from clearvae_torch.train import factories as TF
    from clearvae_torch.train.trainers import DownstreamMLPTrainer

    calls = _count_locks(monkeypatch)
    t = TF.get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=8,
                                alpha=100, temperature=2, device="cpu")
    with pytest.raises(ValueError):
        if which == "vae":
            t.fit(1, None, scan_unroll=-1)
        else:
            DownstreamMLPTrainer(t).fit(1, None, cache_features=False,
                                        style_on_device=True)
    assert len(calls) == 1
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ---------------------------------------------------------------------------
# the lock
# ---------------------------------------------------------------------------

def _child(path, env=None):
    """A process that asks for the lock at ``path`` as if it had a card."""
    code = ("import sys; sys.path.insert(0, sys.argv[2]); "
            "from clearvae_torch.utils import lock; "
            "lock._no_card = lambda: False; "
            "print(lock.acquire_gpu_lock(path=sys.argv[1]))")
    return subprocess.run([sys.executable, "-c", code, path, REPO],
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **(env or {})})


def test_second_process_fails_fast_and_names_the_holder(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("CLEARVAE_TORCH_NO_LOCK", raising=False)
    monkeypatch.setattr(L, "_no_card", lambda: False)
    path = str(tmp_path / "gpu.lock")
    assert L.acquire_gpu_lock(path=path)
    try:
        assert L.acquire_gpu_lock(path=path)  # idempotent
        with open(path) as f:
            info = json.load(f)
        label = os.path.basename(sys.argv[0])
        assert info["pid"] == os.getpid() and info["label"] == label
        r = _child(path)
        assert r.returncode != 0
        assert "another GPU process holds" in r.stderr
        assert f"'pid': {os.getpid()}" in r.stderr
        assert f"'label': '{label}'" in r.stderr
        assert "CLEARVAE_TORCH_NO_LOCK=1" in r.stderr
        # the escape hatch: the second process skips the lock
        r = _child(path, {"CLEARVAE_TORCH_NO_LOCK": "1"})
        assert r.returncode == 0 and r.stdout.strip() == "False"
    finally:
        L.release_gpu_lock()
    r = _child(path)          # released: the next process takes it
    assert r.returncode == 0 and r.stdout.strip() == "True"


def _card_child(tmp_path, card, hold=False):
    """A process on card ``card`` (its UUID replaced by the card's name)
    that asks for its card's lock in ``tmp_path``; with ``hold`` it prints
    once it holds it and waits."""
    code = ("import sys, time; sys.path.insert(0, sys.argv[2]); "
            "from clearvae_torch.utils import lock; "
            "lock._no_card = lambda: False; "
            "lock._card_key = lambda i: 'card-%d' % i; "
            "print(lock.acquire_gpu_lock(device='cuda:' + sys.argv[1]), "
            "flush=True); "
            + ("time.sleep(60)" if hold else ""))
    args = [sys.executable, "-c", code, str(card), REPO]
    env = {k: v for k, v in os.environ.items() if k != "CLEARVAE_TORCH_NO_LOCK"}
    env["TMPDIR"] = str(tmp_path)
    if hold:
        return subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                text=True)
    return subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=120)


def test_the_lock_is_one_per_card(tmp_path):
    """Ranks on different cards each take their own card's lock; a second
    process on a card is refused, naming the holder."""
    holder = _card_child(tmp_path, 0, hold=True)
    try:
        assert holder.stdout.readline().strip() == "True"
        other = _card_child(tmp_path, 1)
        assert other.returncode == 0 and other.stdout.strip() == "True"
        same = _card_child(tmp_path, 0)
        assert same.returncode != 0
        assert "another GPU process holds" in same.stderr
        assert f"'pid': {holder.pid}" in same.stderr
        assert sorted(os.listdir(tmp_path)) == ["clearvae_torch-card-0.lock",
                                                "clearvae_torch-card-1.lock"]
    finally:
        holder.kill()
        holder.wait()


def test_lock_path_names_the_card(monkeypatch):
    monkeypatch.setattr(L, "_card_key", lambda i: f"GPU-{i}")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert L.lock_path("cuda:1").endswith("clearvae_torch-GPU-1.lock")
    assert L.lock_path().endswith("clearvae_torch-GPU-3.lock")
    # a CPU device takes no lock
    monkeypatch.setattr(L, "_no_card", lambda: False)
    assert L.acquire_gpu_lock(device="cpu") is False and not L._held


def test_lock_skips_without_a_card_and_with_the_escape_hatch(tmp_path,
                                                            monkeypatch):
    path = str(tmp_path / "gpu.lock")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CLEARVAE_TORCH_NO_LOCK", raising=False)
    assert L.acquire_gpu_lock(path=path) is False
    monkeypatch.setenv("CLEARVAE_TORCH_NO_LOCK", "1")
    monkeypatch.setattr(L, "_no_card", lambda: False)
    assert L.acquire_gpu_lock(path=path) is False
    assert not os.path.exists(path) and not L._held


# ---------------------------------------------------------------------------
# HierarchicalVAETrainer(eval_evidence_acc=...)
# ---------------------------------------------------------------------------

N_EVAL, BS = 72, 32          # two full batches and a ragged tail of 8


@pytest.fixture(scope="module")
def eval_data():
    imgs, labels = synthetic_mnist(N_EVAL, seed=1)
    return JArrayDataset(np.asarray(jax_make_styled(
        imgs, labels, seed=3).materialize())[..., None], labels,
        np.zeros(N_EVAL, np.int32))


@pytest.mark.parametrize("mode", ["GVAE", "MLVAE"])
@pytest.mark.parametrize("flag", [False, True])
def test_eval_evidence_acc_sets_the_default_eval_step(eval_data, mode, flag):
    jm = JVAE(total_z_dim=16, group_mode=mode, n_classes=10)
    jt = JHTrainer(jm, optax.adam(5e-4), {"beta": 1 / 8}, seed=0,
                   mig_backend="numpy", eval_evidence_acc=flag)
    jt.state = jt._init_state()
    with torch.random.fork_rng(devices=[]):
        tm = TVAE(total_z_dim=16, group_mode=mode, n_classes=10)
    tm.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jt.state.params),
        jax.tree.map(np.asarray, jt.state.batch_stats)))
    tt = HierarchicalVAETrainer(tm, adam(5e-4, "cpu"), {"beta": 1 / 8},
                                seed=0, mig_backend="numpy",
                                eval_evidence_acc=flag, device="cpu")
    assert tt.eval_step is tt._eval_steps[flag]
    # JAX's key chain after init (tests/test_torch_scan_defaults.py): the
    # full batches' scanned program, then the ragged tail
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    rng = jax.random.split(jax.random.key(0))[0]
    rng, k = jax.random.split(rng)
    queue = [_eps(jm, variables, kk, BS)
             for kk in jax.random.split(k, N_EVAL // BS)]
    rng, k = jax.random.split(rng)
    queue.append(_eps(jm, variables, k, N_EVAL % BS))
    draws = list(queue)
    tt._draw_eps = lambda n, out=None: queue.pop(0)
    jmig, jmse = jt.evaluate(eval_data, batch_size=BS)
    mig, mse = tt.evaluate(eval_data, batch_size=BS)
    assert not queue
    np.testing.assert_allclose(mse, jmse, rtol=1e-4)
    assert set(tt.last_eval_totals) == set(jt.last_eval_totals)
    for key, v in jt.last_eval_totals.items():
        np.testing.assert_allclose(tt.last_eval_totals[key], v, rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert np.isfinite(mig) and abs(mig - jmig) < 0.05
    # an explicit with_evidence_acc still overrides the default for one
    # call: the other step's KL_c (group evidence or not), as JAX's
    kl_c = tt.last_eval_totals["kl_c"]
    queue.extend(draws)
    tt.evaluate(eval_data, batch_size=BS, with_evidence_acc=not flag)
    assert tt.eval_step is tt._eval_steps[flag]
    jt.evaluate(eval_data, batch_size=BS, with_evidence_acc=not flag)
    assert not np.isclose(tt.last_eval_totals["kl_c"], kl_c, rtol=1e-3)
    np.testing.assert_allclose(tt.last_eval_totals["kl_c"],
                               jt.last_eval_totals["kl_c"], rtol=1e-4,
                               atol=1e-5)
