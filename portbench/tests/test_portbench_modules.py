"""The check for JAX compares top-level module names whole, and neither the
harness's reference nor its yardstick imports the program or JAX."""

import subprocess
import sys

from portbench import spec


def test_forbidden_loaded():
    assert spec.forbidden_loaded(["jax.numpy"]) == ["jax.numpy"]
    assert spec.forbidden_loaded(["whisper_tpu.ops"]) == ["whisper_tpu.ops"]
    assert spec.forbidden_loaded(["jaxlib", "flax.linen", "whisper_tpu"]) == ["flax.linen", "jaxlib", "whisper_tpu"]
    assert spec.forbidden_loaded(["whisper_tpu_torch.engine", "whisper_tpu_torch", "jaxtyping", "numpy"]) == []


def test_reference_and_yardstick_stand_alone():
    """Importing the reference, the roofline and the trace reader loads
    neither the program nor JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.whisper_f32, portbench.roofline, portbench.trace\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('whisper_tpu_torch', 'whisper_tpu', 'jax', 'jaxlib', 'flax')]\n"
        "print(bad)\n"
    ) % spec.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
