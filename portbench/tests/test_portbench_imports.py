"""Nothing that the benchmark imports is JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "clearvae_tpu"}

TOPS = ("import json, sys; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"{code}\n{TOPS}"], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole tiny run of a cell on the CPU, as ``python -m portbench.run``
    makes it past its look for a card, and every metric reader."""
    code = ("import torch; torch.set_num_threads(1)\n"
            "from portbench import run as R, harness as H\n"
            "import os\n"
            "for f in os.listdir(os.path.join(H.PKG, 'metrics')):\n"
            "    f.endswith('.py') and H.reader(f[:-3])\n"
            "R.run('vae28-styled6-ondevice', 5, 0.1, device='cpu', overrides="
            "{'traffic': {'n_images': 200}, 'config': {'fit': "
            "{'batch_size': 32}}})")
    tops = _tops(code)
    assert "clearvae_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = ("import portbench.reference.vae, portbench.reference.mig, "
            "portbench.reference.styling.corruptions, "
            "portbench.counts.flops, portbench.counts.k3")
    tops = _tops(code)
    assert not tops & (FORBIDDEN | {"clearvae_torch"})
