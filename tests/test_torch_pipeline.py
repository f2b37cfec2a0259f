"""The port's pipeline- and sequence-parallel encoders
(whisper_tpu_torch/parallel/pipeline.py, sequence.py) and make_mesh on a
world of 8 gloo ranks on the CPU, the cases of tests/test_pipeline.py: each
mesh shape's pp_encode / sp_encode against the JAX package's graphs.encode
and its pp_encode / sp_encode on the 8-device virtual mesh, with the same
weights and mel.

One world runs every case of the file (a module-scoped fixture); its ranks
import neither JAX nor the JAX package. Tolerance: atol 2e-5, rtol 1e-5,
the JAX test's (pp moves whole layers; only the tp all-reduce and the
frame split reorder float adds)."""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.parallel.launch import spawn

DEEP = dict(
    n_mels=80, n_audio_ctx=100, n_audio_state=256, n_audio_head=4, n_audio_layer=4,
    n_vocab=51865, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=2,
)  # fmt: skip
PP_CASES = [
    (dict(dp=2, pp=4), 0),  # default microbatches = pp
    (dict(dp=2, pp=4), 1),  # one microbatch (all bubble)
    (dict(dp=1, pp=2, tp=4), 2),  # tp all-reduce inside each stage
    (dict(dp=2, pp=2, tp=2), 4),  # all three axes at once
]
SP_CASES = [dict(dp=2, sp=4), dict(dp=2, sp=2, tp=2), dict(dp=4, sp=2)]
AXIS_CASES = [dict(dp=2, pp=2, tp=2), dict(dp=4, tp=2), dict(dp=1, pp=2, sp=2, tp=2), dict(dp=4, sp=2)]
BAD_MESHES = [dict(tp=3), dict(dp=3, tp=2)]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _world(flat, mel):
    """Every case on this rank: {case: result}."""
    from whisper_tpu_torch.models.dims import ModelDimensions
    from whisper_tpu_torch.models.params import unflatten_tree
    from whisper_tpu_torch.models.whisper import Whisper
    from whisper_tpu_torch.parallel import make_mesh, pp_encode, shard_params, sp_encode
    from whisper_tpu_torch.parallel.mesh import mesh_shape

    params = unflatten_tree((k, torch.from_numpy(v)) for k, v in flat.items())
    model = Whisper(ModelDimensions(**DEEP), params, device="cpu", compute_dtype=torch.float32)
    out = {"plain": model.encode(mel).numpy()}
    for i, (kw, micro) in enumerate(PP_CASES):
        mesh = make_mesh(device_type="cpu", **kw)
        fn = pp_encode(model, mesh, microbatches=micro)
        out[f"pp{i}"] = fn(shard_params(model.params["encoder"], mesh), mel).numpy()
    for i, kw in enumerate(SP_CASES):
        mesh = make_mesh(device_type="cpu", **kw)
        out[f"sp{i}"] = sp_encode(model, mesh)(shard_params(model.params["encoder"], mesh), mel).numpy()
    out["pp_indivisible"] = _error(lambda: pp_encode(model, make_mesh(dp=1, pp=8, device_type="cpu")))
    mesh = make_mesh(dp=1, sp=8, device_type="cpu")
    enc = shard_params(model.params["encoder"], mesh)
    out["sp_indivisible"] = _error(lambda: sp_encode(model, mesh)(enc, np.zeros((8, 80, 200), np.float32)))
    for i, kw in enumerate(AXIS_CASES):
        mesh = make_mesh(device_type="cpu", **kw)
        out[f"axes{i}"] = (tuple(mesh.mesh_dim_names), mesh_shape(mesh))
    out["dp_default"] = mesh_shape(make_mesh(tp=2, pp=2, device_type="cpu"))
    for i, kw in enumerate(BAD_MESHES):
        out[f"bad{i}"] = _error(lambda: make_mesh(device_type="cpu", **kw))
    return out


@pytest.fixture(scope="module")
def jax_model():
    from whisper_tpu.models import Whisper
    from whisper_tpu.models.dims import ModelDimensions

    return Whisper(ModelDimensions(**DEEP), params=None, name="pp-test", compute_dtype="float32")


@pytest.fixture(scope="module")
def mel():
    rng = np.random.RandomState(5)
    return (rng.randn(8, DEEP["n_mels"], 2 * DEEP["n_audio_ctx"]) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def xa_ref(jax_model, mel):
    return np.asarray(jax_model.encode(mel))


@pytest.fixture(scope="module")
def world(jax_model, mel):
    from whisper_tpu_torch.models.params import flatten_tree

    flat = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax_model.params)}
    results = spawn(_world, 8, flat, mel, device_type="cpu", timeout=300)
    for r in results[1:]:  # SPMD: every rank returns the same outputs
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, results[0][k], err_msg=k)
            else:
                assert v == results[0][k], k
    return results[0]


def _jax_mesh(**kw):
    import jax

    from whisper_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(**kw)


def test_plain_encode_matches_jax(world, xa_ref):
    np.testing.assert_allclose(world["plain"], xa_ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("case", range(len(PP_CASES)))
def test_pp_encode_matches_single_device(world, xa_ref, jax_model, mel, case):
    from whisper_tpu.parallel.pipeline import pp_encode

    kw, micro = PP_CASES[case]
    got = world[f"pp{case}"]
    assert got.shape == xa_ref.shape
    np.testing.assert_allclose(got, xa_ref, atol=2e-5, rtol=1e-5)
    jax_fn = pp_encode(jax_model, _jax_mesh(**kw), microbatches=micro)
    np.testing.assert_allclose(got, np.asarray(jax_fn(jax_model.params["encoder"], mel)), atol=2e-5, rtol=1e-5)


def test_pp_encode_rejects_indivisible_layers(world):
    """pp must divide the layer stack: a silent mis-split would drop layers."""
    assert "not divisible by pp" in world["pp_indivisible"]


@pytest.mark.parametrize("case", range(len(SP_CASES)))
def test_sp_encode_matches_single_device(world, xa_ref, jax_model, mel, case):
    from whisper_tpu.parallel.sequence import sp_encode

    got = world[f"sp{case}"]
    assert got.shape == xa_ref.shape
    np.testing.assert_allclose(got, xa_ref, atol=2e-5, rtol=1e-5)
    jax_fn = sp_encode(jax_model, _jax_mesh(**SP_CASES[case]))
    np.testing.assert_allclose(got, np.asarray(jax_fn(jax_model.params["encoder"], mel)), atol=2e-5, rtol=1e-5)


def test_sp_encode_rejects_indivisible_frames(world):
    """T = 100 frames, sp = 8: an uneven split would corrupt positions."""
    assert "not divisible by sp" in world["sp_indivisible"]


@pytest.mark.parametrize("case", range(len(AXIS_CASES)))
def test_make_mesh_axis_order(world, case):
    """(dp, pp, sp, tp): tp innermost, dp outermost, pp and sp only when
    > 1; the JAX package's names and shapes."""
    names, shape = world[f"axes{case}"]
    want = _jax_mesh(**AXIS_CASES[case])
    assert names == tuple(want.axis_names)
    assert shape == dict(want.shape)


def test_make_mesh_defaults_and_errors(world):
    assert world["dp_default"] == {"dp": 2, "pp": 2, "tp": 2}
    assert world["bad0"] == "8 devices not divisible by tp*pp*sp=3"
    assert world["bad1"] == "mesh dp3*pp1*sp1*tp2 != 8 devices"
