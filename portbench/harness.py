"""One run of one cell: set-up, the measured window (or the traced stretch),
the per-layer readers, and the check of what the program computed.

A cell is ``workloads/<cell>.json``: its configuration (``configs/``), its
traffic mix (``traffic/<mix>.json``, which names its maker
``traffic/<maker>.py``), the metrics it reports (each per-layer one a
reader ``metrics/<metric>.py``), the traced stretch and the limits of the
check. All are found by name, so a new cell, configuration, traffic mix or
metric is a new file.

The program under test is ``clearvae_torch``: the trainer its factory builds
with the configuration's arguments, trained by ``TrainerCore.fit`` (graphed,
its default) on the program's datasets of the benchmark's inputs. The
benchmark makes the inputs and the weights from ``--seed`` on the device and
hands the same to the program and to the plain reference that the
configuration names (``reference/<name>.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

from portbench import trace as T

PKG = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clearvae_tpu")
# the train steps that the check follows: fit's three warm-up calls, the
# capture with the first replay, and a second replay
CHECK_STEPS = 5


def load(kind: str, name: str) -> dict:
    with open(os.path.join(PKG, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def batch_size(self) -> int:
        return self.config["fit"]["batch_size"]

    @property
    def validate(self) -> bool:
        return bool(self.traffic.get("validate", False))

    @property
    def style_on_device(self) -> bool:
        return bool(self.traffic.get("style_on_device", False))

    @property
    def round_epochs(self) -> int:
        """Epochs a turn of the window: whole validation periods where the
        cell validates, so every window holds its share of validations."""
        if not self.validate:
            return 1
        return self.config["trainer"]["kwargs"]["verbose_period"]


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell's files; ``overrides`` {"traffic"|"config"|"workload":
    {key: value}} replaces top-level keys (the CPU tests run tiny cells)."""
    workload = load("workloads", name)
    parts = {"workload": workload,
             "config": load("configs", workload["config"]),
             "traffic": load("traffic", workload["traffic"])}
    for kind, kv in (overrides or {}).items():
        for k, v in kv.items():
            parts[kind][k] = ({**parts[kind][k], **v} if isinstance(v, dict)
                              and isinstance(parts[kind].get(k), dict) else v)
    return Cell(name, parts["workload"], parts["config"], parts["traffic"])


def maker(cell: Cell):
    return importlib.import_module(f"portbench.traffic.{cell.traffic['maker']}")


def reference(cell: Cell):
    """The plain reference module that the configuration names
    (``reference/<name>.py``): ``param_spec``, ``train_noise``, ``train``
    and ``validate``."""
    return importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")


def reader(metric: str):
    """The reader module ``metrics/<metric>.py`` (a metric's name may hold
    dots, so it is loaded by path)."""
    path = os.path.join(PKG, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seeds(seed: int) -> dict:
    """Independent seeds of the inputs, the weights and the trainer (its
    noise generator and shuffles) from ``--seed``; the trainer's is below
    2^31, as numpy's shuffles of ``seed + epoch`` need."""
    data, weights, trainer = np.random.SeedSequence(
        seed % 2 ** 64).generate_state(3)
    return {"data": int(data), "weights": int(weights),
            "trainer": int(trainer) % 2 ** 31}


# -- the program ----------------------------------------------------------------


def build_trainer(cell: Cell, seed: int, device):
    from clearvae_torch.train import factories

    t = cell.config["trainer"]
    return getattr(factories, t["factory"])(**t["kwargs"], seed=seed,
                                            device=device)


def make_weights(spec, seed: int, device) -> dict:
    """Every parameter of ``spec`` [(name, shape, bound)], drawn on
    ``device`` in one call from a seeded generator: uniform in ±bound,
    BatchNorm scales around 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for (name, shape, bound), n in zip(spec, sizes):
        v = u[off:off + n].view(shape) * bound
        if ".bns." in name and name.endswith(".weight"):
            v = v + 1
        out[name] = v
        off += n
    return out


def load_weights(model, weights: dict) -> None:
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise RuntimeError(
            "the program's parameters are not the reference's: "
            f"only the program has {sorted(set(names) - set(weights))}, "
            f"only the reference {sorted(set(weights) - set(names))}")
    with torch.no_grad():
        for k, p in names.items():
            if p.shape != weights[k].shape:
                raise RuntimeError(f"{k}: the program's shape {tuple(p.shape)}"
                                   f" is not {tuple(weights[k].shape)}")
            p.copy_(weights[k])


class Observer:
    """What the check reads from the program, taken as it runs: after the
    first train step the gradient that the optimizer took (Adam's first
    moment over 1 − β1), after ``CHECK_STEPS`` steps the parameters; at
    each ``evaluate`` the model's state and the noise generator's before
    the call, and its result. A step is counted where it runs: an
    optimizer update outside a capture (the warm-up calls; on the CPU
    every step), or, inside ``counting_replays``, a replay of the first
    CUDA graph replayed (the train step's). ``evaluate`` is wrapped on the
    trainer, so in-fit validation goes through the wrapper;
    ``original_evaluate`` is the program's."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.names = {id(p): k for k, p in trainer.model.named_parameters()}
        self.steps = 0
        self.grad1 = None
        self.params = None
        self.train_graph = None
        self.validation = None      # (state, generator state, result)
        self.validations = 0
        self.validation_s = []      # each call's wall, to a synchronize
        self.original_evaluate = trainer.evaluate
        trainer.optimizer.register_step_post_hook(self._after_update)
        trainer.evaluate = self._evaluate

    def _after_update(self, optimizer, args, kwargs):
        p0 = optimizer.param_groups[0]["params"][0]
        if p0.is_cuda and torch.cuda.is_current_stream_capturing():
            return                  # a capture runs nothing
        self._stepped(optimizer)

    def _stepped(self, optimizer):
        self.steps += 1
        if self.steps == 1:
            beta1 = optimizer.param_groups[0]["betas"][0]
            self.grad1 = {
                self.names[id(p)]: (optimizer.state[p]["exp_avg"] / (1 - beta1)
                                    if "exp_avg" in optimizer.state.get(p, {})
                                    else torch.zeros_like(p)).detach().clone()
                for g in optimizer.param_groups for p in g["params"]}
        if self.steps == CHECK_STEPS:
            self.params = {k: p.detach().clone() for k, p in
                           self.trainer.model.named_parameters()}

    @contextlib.contextmanager
    def counting_replays(self):
        """Count each replay of the train step's graph as a step (the
        first graph replayed: a validation's comes after the epoch's
        steps)."""
        replay, obs = torch.cuda.CUDAGraph.replay, self

        def counted(graph):
            replay(graph)
            if obs.train_graph is None:
                obs.train_graph = graph
            if graph is obs.train_graph:
                obs._stepped(obs.trainer.optimizer)

        torch.cuda.CUDAGraph.replay = counted
        try:
            yield
        finally:
            torch.cuda.CUDAGraph.replay = replay
            self.train_graph = None

    def _evaluate(self, *args, **kwargs):
        t = self.trainer
        state = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
        gen = t.generator.get_state()
        t0 = time.perf_counter()
        with torch.profiler.record_function(T.VALIDATION):
            out = self.original_evaluate(*args, **kwargs)
        self.validation_s.append(time.perf_counter() - t0)
        self.validation = (state, gen, out)
        self.validations += 1
        return out


@dataclasses.dataclass
class Run:
    cell: Cell
    seeds: dict
    device: torch.device
    data: dict
    datasets: dict
    trainer: object
    weights: dict
    observer: Observer
    n_train: int

    def fit(self, epochs: int, start: int):
        c = self.cell
        self.trainer.fit(epochs, self.datasets["train"],
                         self.datasets.get("valid") if c.validate else None,
                         batch_size=c.batch_size,
                         style_on_device=c.style_on_device, start_epoch=start)

    def batches(self, epoch: int) -> np.ndarray:
        """[n_batches, B] rows of the train split in epoch ``epoch``: the
        order ``fit`` documents (``RandomState(seed + epoch)``'s permutation,
        the ragged tail dropped)."""
        n, b = self.n_train, self.cell.batch_size
        p = np.random.RandomState(self.seeds["trainer"] + epoch).permutation(n)
        return p[: (n // b) * b].reshape(n // b, b)


def set_up(cell: Cell, seed: int, device) -> Run:
    """Inputs and weights from the seed, the trainer, and its first epoch
    through ``fit`` (its warm-up steps, the capture of its graph and, where
    the cell validates, the validation and its graph)."""
    device = torch.device(device)
    clock = Phases(device)
    seeds = sub_seeds(seed)
    mk = maker(cell)
    data = mk.make(cell.traffic, seeds["data"], device)
    clock("inputs made")
    datasets = mk.program_datasets(data)
    clock("datasets")
    trainer = build_trainer(cell, seeds["trainer"], device)
    weights = make_weights(reference(cell).param_spec(cell.config),
                           seeds["weights"], device)
    load_weights(trainer.model, weights)
    clock("trainer and weights")
    run = Run(cell, seeds, device, data, datasets, trainer, weights,
              Observer(trainer), len(datasets["train"]))
    if len(run.batches(0)) < CHECK_STEPS:
        raise ValueError(f"an epoch of {len(run.batches(0))} steps: the "
                         f"check follows the first {CHECK_STEPS} of epoch 0")
    with run.observer.counting_replays():
        run.fit(1, 0)
    clock("epoch 0 (warm-up, capture" + (", validation)" if cell.validate
                                         else ")"))
    # a full collection of what the imports made, here rather than inside
    # the window (none ran in the window with it, on an H100)
    gc.collect()
    clock("garbage collection")
    return run


class Phases:
    """Prints on standard error the seconds that each phase of the set-up
    took, up to a device synchronize."""

    def __init__(self, device):
        self.device, self.t = device, time.perf_counter()

    def __call__(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"portbench: set-up {phase}: {now - self.t:.3f} s",
              file=sys.stderr)
        self.t = now


def window(run: Run, seconds: float) -> dict:
    """Whole turns of ``fit`` epochs from epoch 1 until ``seconds`` have
    passed; the wall runs from the first epoch's start to a device
    synchronize after the last."""
    c = run.cell
    epoch, t0 = 1, time.perf_counter()
    turns = []
    while True:
        run.fit(c.round_epochs, epoch)
        epoch += c.round_epochs
        turns.append(time.perf_counter() - t0 - sum(turns))
        if time.perf_counter() - t0 >= seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    wall = time.perf_counter() - t0
    print(f"portbench: window turns of {c.round_epochs} epoch(s): "
          + " ".join(f"{t:.4f}" for t in turns) + " s; validations "
          + " ".join(f"{t:.4f}" for t in run.observer.validation_s[1:])
          + " s", file=sys.stderr)
    steps = (epoch - 1) * len(run.batches(0))
    return {"start": t0, "wall_s": wall, "epochs": list(range(1, epoch)),
            "steps": steps, "images": steps * c.batch_size}


def _synchronize(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def traced_stretch(run: Run) -> tuple:
    """The traced stretch, as ``workload["trace"]`` sets it, and an untraced
    run of the same steps just before it, which ``step.mfu`` reads: the
    profiler slows the steps it traces. ``{"epochs": n}``: n epochs of
    ``fit``, one call each, profiled, after untraced epochs of ``fit``
    that do not validate (one; where the cell validates, those of its
    validation period before the stretch, which ends with the period, so
    that its last epoch validates). ``{"steps": k, "skip": s}``: steps
    s + 1 to s + k of one epoch of ``fit``, after its untraced steps 1 to
    s (for a cell whose epoch is too long to trace whole, and which does
    not validate). Returns (stretch facts, Trace); the facts' "untraced"
    holds the untraced steps' images and wall."""
    spec = run.cell.workload["trace"]
    if "steps" in spec:
        return _traced_steps(run, spec["steps"], spec["skip"])
    c = run.cell
    n = spec["epochs"]
    first = 2
    if c.validate:
        period = c.round_epochs
        first = -(-n // period) * period - n + 1
        if first == 1:
            raise ValueError("a traced stretch of whole validation periods "
                             "leaves no untraced epoch before it")
    _synchronize(run)
    t0 = time.perf_counter()
    run.fit(first - 1, 1)
    _synchronize(run)
    untraced = {"images": (first - 1) * len(run.batches(0)) * c.batch_size,
                "wall_s": time.perf_counter() - t0}
    before = run.observer.validations
    with T.profiled() as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(T.STRETCH):
            for e in range(first, first + n):
                with torch.profiler.record_function(T.EPOCH):
                    run.fit(1, e)
            torch.cuda.synchronize(run.device)
        wall = time.perf_counter() - t0
    tr = T.read(prof)
    epochs = list(range(first, first + n))
    batches = [b for e in epochs for b in run.batches(e)]
    facts = {"wall_s": wall, "epochs": epochs, "batches": batches,
             "steps": len(batches), "images": len(batches) * c.batch_size,
             "validations": run.observer.validations - before,
             "untraced": untraced}
    return facts, tr


class _ReplayWindow:
    """Profiles graph replays ``skip + 1`` to ``skip + k`` of the calls
    inside its block: ``torch.cuda.CUDAGraph.replay`` is wrapped there to
    count them, and starts the profiler (and its stretch ranges) after
    replay ``skip`` and stops it after replay ``skip + k``, each edge at a
    device synchronize. ``untraced_s``: from the block's start to that
    synchronize after replay ``skip``."""

    def __init__(self, skip: int, k: int):
        from torch.profiler import ProfilerActivity, profile

        self.skip, self.k, self.n = skip, k, 0
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.ranges, self.t0, self.wall = [], None, None
        self.start, self.untraced_s = None, None

    def __enter__(self):
        torch.cuda.synchronize()
        self.start = time.perf_counter()
        self.replay = torch.cuda.CUDAGraph.replay
        window = self

        def replay(graph):
            window.replay(graph)
            window.n += 1
            if window.n == window.skip:
                window._open()
            elif window.n == window.skip + window.k:
                window._close()

        torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph.replay = self.replay
        if self.wall is None and self.t0 is not None:
            self._close()

    def _open(self):
        torch.cuda.synchronize()
        self.untraced_s = time.perf_counter() - self.start
        self.prof.start()
        time.sleep(T.SETTLE_S)
        self.ranges = [torch.profiler.record_function(T.STRETCH),
                       torch.profiler.record_function(T.EPOCH)]
        for r in self.ranges:
            r.__enter__()
        self.t0 = time.perf_counter()

    def _close(self):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        for r in reversed(self.ranges):
            r.__exit__(None, None, None)
        time.sleep(T.SETTLE_S)
        self.prof.stop()


def _traced_steps(run: Run, k: int, skip: int) -> tuple:
    """Steps ``skip + 1`` to ``skip + k`` of epoch 1, traced. The steps a
    replay takes come from ``fit``'s history: the epoch's steps over its
    replays, which has to be a whole number."""
    if run.cell.validate:
        raise ValueError("a stretch of steps is for a cell that does not "
                         "validate")
    with _ReplayWindow(skip, k) as w:
        run.fit(1, 1)
    if w.wall is None:
        raise RuntimeError(f"the epoch replayed {w.n} graphs, fewer than "
                           f"the stretch's {skip + k}")
    steps = len(run.trainer.history[-1]["loss"])
    if steps % w.n:
        raise RuntimeError(f"the epoch took {steps} steps in {w.n} graph "
                           "replays: not a whole number of steps a replay")
    per = steps // w.n
    b = run.cell.batch_size
    batches = list(run.batches(1)[skip * per:(skip + k) * per])
    facts = {"wall_s": w.wall, "epochs": [1], "batches": batches,
             "steps": k * per, "images": k * per * b, "validations": 0,
             "untraced": {"images": skip * per * b,
                          "wall_s": w.untraced_s}}
    return facts, T.read(w.prof)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the cell, the run, the traced
    stretch's facts and its trace. A reader that measures for itself
    (``BEFORE_TRACE = True``) runs before the stretch, on a process that
    the profiler has not yet touched, and gets neither."""

    cell: Cell
    run: Run
    stretch: dict | None = None
    trace: T.Trace | None = None

    def data_file(self, name: str):
        with open(os.path.join(PKG, "metrics", name)) as f:
            return json.load(f)


def release(run: Run) -> list:
    """Free the program's state (its trainer, graphs and datasets) and
    return the loss history of every epoch, [n_batches] arrays in order."""
    history = [np.asarray(h["loss"]) for h in run.trainer.history]
    run.trainer = run.datasets = run.observer.trainer = None
    run.observer.original_evaluate = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return history


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
