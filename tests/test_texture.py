"""Texture loading and sampling: RGBE decode, Radiance .hdr parsing,
sampler modes, env-map mapping (w3e4.wgsl:196-216, w9e2.wgsl:234-246)."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest

from tracer.render import texture as T


def _write_hdr_flat(path, rgbe):
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.astype(np.uint8).tobytes())


def _write_hdr_rle(path, rgbe):
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 0xFF]))
            for c in range(4):
                row = rgbe[y, :, c]
                x = 0
                while x < w:
                    # runs of equal bytes vs literal spans (max 127/128)
                    run = 1
                    while (x + run < w and run < 127
                           and row[x + run] == row[x]):
                        run += 1
                    if run >= 2:
                        f.write(bytes([128 + run, int(row[x])]))
                        x += run
                    else:
                        lit = 1
                        while (x + lit < w and lit < 128
                               and not (x + lit + 1 < w
                                        and row[x + lit]
                                        == row[x + lit + 1])):
                            lit += 1
                        f.write(bytes([lit]))
                        f.write(row[x : x + lit].astype(np.uint8).tobytes())
                        x += lit


@pytest.fixture
def rgbe_img():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, size=(4, 16, 4), dtype=np.uint8)
    img[:, :5] = [10, 20, 30, 130]  # guaranteed runs
    return img


def test_radiance_flat_roundtrip(tmp_path, rgbe_img):
    p = str(tmp_path / "flat.hdr")
    _write_hdr_flat(p, rgbe_img)
    out = T._read_radiance_rgbe(p)
    np.testing.assert_array_equal(out, rgbe_img)


def test_radiance_rle_roundtrip(tmp_path, rgbe_img):
    p = str(tmp_path / "rle.hdr")
    _write_hdr_rle(p, rgbe_img)
    out = T._read_radiance_rgbe(p)
    np.testing.assert_array_equal(out, rgbe_img)


def test_rgbe_decode_matches_reference_formula():
    # w9e2.wgsl:242-245: rgb * 2^(a*255 - 128) with channels in [0,1]
    data = jnp.asarray(
        np.array([[[0.5, 0.25, 1.0, 130.0 / 255.0]]], np.float32)
    )
    tex = T.TextureBuf(data=data, kind=T.ENV_RGBE)
    rgb = np.asarray(T.sample_nearest(tex, jnp.array(0.5), jnp.array(0.5)))
    np.testing.assert_allclose(rgb, [2.0, 1.0, 4.0], rtol=1e-6)


def test_env_map_poles_and_seam():
    # v=0 row (image top after the flip) must be the -y pole; u wraps at
    # the +-pi seam of atan2.
    h, w = 8, 16
    img = np.zeros((h, w, 4), np.float32)
    img[..., 3] = 0.5019608  # exponent 0 -> identity scale
    img[0, :, 0] = 1.0  # stored top row: red
    img[-1, :, 1] = 1.0  # stored bottom row: green
    tex = T.TextureBuf(data=jnp.asarray(img), kind=T.ENV_RGBE)
    def look(y):
        d = np.array([[0.1, y, 0.1]], np.float32)
        d /= np.linalg.norm(d)
        return np.asarray(T.environment_map(tex, jnp.asarray(d)))[0]

    down = look(-0.95)  # v ~ 0 -> sampled near (u, 1): stored bottom row
    up = look(0.95)  # v ~ 1 -> sampled near (u, 0): stored top row
    assert down[1] > down[0], down
    assert up[0] > up[1], up
    # u seam: atan2 wraps at -z; +z-facing and slightly-rotated directions
    # must land half a texture apart, not adjacent.
    u_plus_z = 0.5 * (1.0 + np.arctan2(0.0, -1.0) / np.pi)
    assert abs(u_plus_z - 1.0) < 1e-6


def test_rgbe_png_fixture_end_to_end():
    """The checked-in .hdr.png fixture exercises the real w9e2 asset path
    (load_rgbe_png -> ENV_RGBE -> environment_map lat-long sampling),
    which the reference mount's missing luxo_pxr_campus.hdr.png otherwise
    leaves untested."""
    import os

    import jax.numpy as jnp

    p = os.path.join(os.path.dirname(__file__), "fixtures",
                     "tiny_env.hdr.png")
    tex = T.load_rgbe_png(p)
    assert tex.kind == T.ENV_RGBE
    assert tex.data.shape == (8, 16, 4)
    # Decode formula check on a known texel: row 7 stores blue ~4.0.
    texel = np.asarray(tex.data)[7, 0]
    blue = texel[2] * 2.0 ** (texel[3] * 255.0 - 128.0)
    assert abs(blue - 4.0) < 0.05
    # Lat-long sampling: -y looks at v=1 (bottom row) where blue ~4.
    d = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    rgb = np.asarray(T.environment_map(tex, d))[0]
    assert rgb[2] > 2.0  # HDR value survived the png round trip
