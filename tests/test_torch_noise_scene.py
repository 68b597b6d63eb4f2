"""Noise and procedural volumes: the PyTorch port against the JAX package
on the same inputs. Hashes must be bit-equal; float outputs agree to
atol 1e-5 (float32 noise in [-1, 1] summed over five octaves, where the
two libraries may round a fused multiply-add differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu.config import NoiseChannelConfig as JNoise
from volumetricrenderer_tpu.config import VolumeConfig as JVolume
from volumetricrenderer_tpu.models import scene as jscene
from volumetricrenderer_tpu.ops import noise as jnoise
from volumetricrenderer_tpu_torch.config import NoiseChannelConfig as TNoise
from volumetricrenderer_tpu_torch.config import VolumeConfig as TVolume
from volumetricrenderer_tpu_torch.models import scene as tscene
from volumetricrenderer_tpu_torch.ops import noise as tnoise

torch.set_num_threads(1)

ATOL = 1e-5


def _lattice(seed, n=4096):
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int32)
    coords = [rng.integers(info.min, info.max, n, dtype=np.int64)
              .astype(np.int32) for _ in range(3)]
    coords[0][:8] = [0, -1, 1, info.min, info.max, -2, 2, -1000]
    return coords


@pytest.mark.parametrize("seed", [0, 7, 7 + 4 * 1013, 2**31 - 1])
def test_hash3_bit_equal(seed):
    ix, iy, iz = _lattice(seed)
    want = np.asarray(jnoise._hash3(jnp.asarray(ix), jnp.asarray(iy),
                                    jnp.asarray(iz), seed)).astype(np.int64)
    got = tnoise._hash3(torch.from_numpy(ix), torch.from_numpy(iy),
                        torch.from_numpy(iz), seed).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tnoise._hash_to_unit(torch.from_numpy(got)).numpy(),
        np.asarray(jnoise._hash_to_unit(jnp.asarray(want.astype(np.uint32)))))


def _coords(seed, shape=(2000, 3), scale=40.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 11])
def test_perlin3(seed):
    c = _coords(seed)
    np.testing.assert_allclose(tnoise.perlin3(torch.from_numpy(c), seed),
                               np.asarray(jnoise.perlin3(jnp.asarray(c), seed)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("octaves", [1, 5])
def test_fbm3(octaves):
    c = _coords(5, scale=8.0)
    np.testing.assert_allclose(
        tnoise.fbm3(torch.from_numpy(c), 7, octaves=octaves),
        np.asarray(jnoise.fbm3(jnp.asarray(c), 7, octaves=octaves)),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind,octaves", [("perlin", 1), ("fbm", 5)])
def test_noise_grid(kind, octaves):
    np.testing.assert_allclose(
        tnoise.noise_grid(kind, 12, 0.19, 3, octaves=octaves),
        np.asarray(jnoise.noise_grid(kind, 12, 0.19, 3, octaves=octaves)),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["simplex", "cellular"])
def test_unported_noise_raises(kind):
    """Simplex and cellular noise are ported: only a kind that neither
    package knows raises."""
    assert tnoise.noise_grid(kind, 4, 0.1, 1).shape == (4, 4, 4)
    with pytest.raises(ValueError, match="unknown noise kind"):
        tnoise.noise_grid(kind + "3", 4, 0.1, 1)


@pytest.mark.parametrize("name", ["simplex3", "cellular3"])
@pytest.mark.parametrize("seed", [4, 11])
def test_simplex_and_cellular(name, seed):
    c = _coords(seed)
    c[:4] = [[0, 0, 0], [1, 1, 1], [-1, 2, -3], [0.5, 0.5, 0.5]]
    got = getattr(tnoise, name)(torch.from_numpy(c), seed)
    want = np.asarray(getattr(jnoise, name)(jnp.asarray(c), seed))
    assert got.dtype == torch.float32 and float(got.std()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["simplex", "cellular"])
def test_noise_grid_simplex_cellular(kind):
    np.testing.assert_allclose(
        tnoise.noise_grid(kind, 12, 0.15, 4),
        np.asarray(jnoise.noise_grid(kind, 12, 0.15, 4)), rtol=0, atol=ATOL)


def test_cloud_volume():
    want = np.asarray(jscene.cloud_volume(32, 7))
    got = tscene.cloud_volume(32, 7, device="cpu")
    assert got.shape == (32, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_build_volume():
    chans = [("perlin", 0.08, 3, 1, 4), ("fbm", 4.0 / 16, 7, 2, 1)]
    jv = JVolume(size=12, channels=tuple(JNoise(k, f, s, o, p)
                                         for k, f, s, o, p in chans))
    tv = TVolume(size=12, channels=tuple(TNoise(k, f, s, o, p)
                                         for k, f, s, o, p in chans))
    got = tscene.build_volume(tv, device="cpu")
    assert got.shape == (12, 12, 12, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jscene.build_volume(jv)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_build_volume_reference_recipe(quantize):
    """The reference preset's recipe (cellular, cellular, Perlin, simplex;
    channel 0 sharpened by pow 4) at size 16. Quantized values may land one
    unorm level apart where the float grids differ in the last bit."""
    got = tscene.build_volume(TVolume(size=16, quantize_uint8=quantize),
                              device="cpu")
    want = np.asarray(jscene.build_volume(JVolume(size=16,
                                                  quantize_uint8=quantize)))
    assert got.shape == (16, 16, 16, 4) and got.dtype == torch.float32
    assert [c.kind for c in TVolume().channels] == \
        ["cellular", "cellular", "perlin", "simplex"]
    if quantize:
        diff = np.abs(got.numpy() - want)
        assert diff.max() <= 1.0 / 255.0 + 1e-7 and (diff > 0).mean() < 1e-3
        np.testing.assert_array_equal(np.round(got.numpy() * 255.0),
                                      got.numpy() * 255.0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    for c in range(4):
        assert float(got[..., c].min()) == 0.0
        assert float(got[..., c].max()) == 1.0


_CONSTRUCTORS = {  # name -> (the port's arguments, the JAX package's)
    "cloud_volume": ((12, 7), (12, 7)),
    "build_volume": ((TVolume(size=8),), (JVolume(size=8),)),
    "smoke_volume": ((12, 23), (12, 23)),
    "translate_w2l": ((0.25, -0.5, 0.125), (0.25, -0.5, 0.125)),
    "config3_scene": ((8,), (8,)),
}


def _arrays(value):
    """The arrays of a constructor's result: a grid or a matrix, or each
    volume's grid and world_to_local."""
    if isinstance(value, list):
        return [a for v in value for a in (v.grid, v.world_to_local)]
    return [value]


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_volume_constructors_default_to_the_gpu(name):
    """cloud_volume, build_volume, smoke_volume, translate_w2l and
    config3_scene build on `device`, "cuda" by default: without a GPU the
    default raises torch's own error, and device="cpu" builds the JAX
    package's values on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    args, jargs = _CONSTRUCTORS[name]
    with pytest.raises((RuntimeError, AssertionError)):
        getattr(tscene, name)(*args)
    got = _arrays(getattr(tscene, name)(*args, device="cpu"))
    want = _arrays(getattr(jscene, name)(*jargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
