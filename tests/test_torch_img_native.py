"""The request path's frame conversions (`utils/img_util.py`: `img2batch`,
`batch2img`) through the port's native frame pass (`csrc/frames.cc`, bound
in `utils/frames.py`) against the JAX package's `img_util`, and against the
port's numpy route, which a library that cannot be built forces
(`frames._load` returning None), on the CPU.

Bit for bit: the native pass divides by 255 in float32 through a table of
IEEE divisions, and clamps, multiplies by 255 in float32 and rounds half to
even as numpy does. Inputs the native pass does not take keep the numpy
route, and each engaged call counts once in the function's `fused_calls`.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from wavemamba_torch.utils import cxx, frames, img_util
from wavemamba_tpu.utils import img_util as jimg


@pytest.fixture
def numpy_route(monkeypatch):
    """`fn(*args, **kw)` with the library unavailable: the numpy route."""
    def call(fn, *args, **kw):
        with monkeypatch.context() as m:
            m.setattr(frames, "_load", lambda: None)
            assert not frames.available()
            with np.errstate(invalid="ignore"):  # numpy warns as it casts NaN
                return fn(*args, **kw)
    return call


def _jax(fn, *args, **kw):
    """The JAX package's `img_util.<fn>`: the witness of the bits."""
    with np.errstate(invalid="ignore"):  # numpy warns as it casts NaN
        return getattr(jimg, fn)(*args, **kw)


def _engaged(fn, *args, **kw):
    """fn's result and how many of its calls took the native pass."""
    before = fn.fused_calls
    out = fn(*args, **kw)
    return out, fn.fused_calls - before


def _u8(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _ties():
    """float32 values that hit the rounding's corners: the float32 nearest
    to each (k + 0.5) / 255 and its two neighbours (x * 255 lands on, just
    under or just over a half), NaN, +-inf, -0.0, 0, 1, just below 0 and
    just above 1."""
    mid = ((np.arange(255) + 0.5) / 255).astype(np.float32)
    near = np.concatenate([mid, np.nextafter(mid, np.float32(0)), np.nextafter(mid, np.float32(1))])
    tiny = np.float32(1e-45)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -tiny, np.nextafter(
        np.float32(0), np.float32(-1)), np.nextafter(np.float32(1), np.float32(2)), 1.0 + 2e-7,
        0.5 / 255, 254.5 / 255, -1e30, 1e30], np.float32)
    return np.concatenate([near, special]).astype(np.float32)


def _frames():
    """(id, uint8 frame) cases of `img2batch`."""
    big = _u8(531, 1049, 3)
    every = np.arange(256, dtype=np.uint8)
    return [("1x1", _u8(1, 1)), ("7x13", _u8(7, 13)), ("517x1031", _u8(517, 1031)),
            ("5x40000", _u8(5, 40000)),  # more threads than a row each would get
            ("row_strided", big[3:520, 7:1038]), ("rows_reversed", big[::-1][:33]),
            ("columns_strided", big[:40, ::3]), ("columns_reversed", big[:40, ::-1]),
            ("planar", np.ascontiguousarray(big[:61, :77].transpose(2, 0, 1)).transpose(1, 2, 0)),
            ("all_256", np.stack([every, every[::-1], np.roll(every, 85)], -1).reshape(16, 16, 3))]


def _batches():
    """(id, float32 batch) cases of `batch2img`."""
    rs = np.random.RandomState(4)

    def uniform(*shape):
        return (rs.rand(*shape) * 1.4 - 0.2).astype(np.float32)

    ties = _ties()
    pad = -ties.size % 3
    tie_img = np.concatenate([ties, np.zeros(pad, np.float32)]).reshape(1, 1, -1, 3)
    big = uniform(1, 530, 1040, 3)
    return [("1x1", uniform(1, 1, 1, 3)), ("7x13", uniform(1, 7, 13, 3)),
            ("517x1031", uniform(1, 517, 1031, 3)), ("5x40000", uniform(1, 5, 40000, 3)),
            ("row_strided", big[:, 2:519, 5:1036]), ("hw3", uniform(9, 11, 3)),
            ("columns_strided", big[:, :40, ::3]), ("columns_reversed", big[:, :40, ::-1]),
            # the model's output as `enhance` returns it: an NCHW result
            # cropped, copied to the host densely and seen as NHWC
            ("planar", np.ascontiguousarray(big[:, :517, :1031].transpose(0, 3, 1, 2)).transpose(
                0, 2, 3, 1)),
            ("planar_cropped", big.transpose(0, 3, 1, 2)[:, :, 3:500, 1:1000].transpose(0, 2, 3, 1)),
            ("batch_of_3", uniform(3, 17, 19, 3)), ("ties", tie_img),
            ("ties_shuffled", rs.permutation(np.tile(ties, 40))[:3 * 33 * 31].reshape(1, 33, 31, 3))]


def test_the_frame_library_builds_from_the_source_into_build():
    """`csrc/frames.cc` -> `build/wavemamba_torch/libwmframes_<hash>.so`,
    with the flags of the port's other host library."""
    path = frames.build()
    assert path.parent == cxx.ROOT / "build" / "wavemamba_torch"
    assert path.name.startswith("libwmframes_") and path.suffix == ".so"
    assert frames.SOURCE == cxx.ROOT / "wavemamba_torch" / "csrc" / "frames.cc"
    assert frames.build() == path  # made once
    assert frames.available()


@pytest.mark.parametrize("case", [c[0] for c in _frames()])
def test_img2batch_native_pass_is_jaxs_bits(case, numpy_route):
    img = dict(_frames())[case]
    got, engaged = _engaged(img_util.img2batch, img)
    want = _jax("img2batch", img)
    assert engaged == 1
    np.testing.assert_array_equal(numpy_route(img_util.img2batch, img), want)
    assert got.dtype == want.dtype == np.float32 and got.shape == (1, *img.shape)
    assert got.flags.c_contiguous and not np.shares_memory(got, img)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", [c[0] for c in _batches()])
def test_batch2img_native_pass_is_jaxs_bits(case, numpy_route):
    batch = dict(_batches())[case]
    got, engaged = _engaged(img_util.batch2img, batch)
    want = _jax("batch2img", batch)
    assert engaged == 1
    np.testing.assert_array_equal(numpy_route(img_util.batch2img, batch), want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_batch2img_specials_read_as_numpy_casts_them():
    """NaN 0, +inf 255, -inf 0, -0.0 0, just above 1 255, just below 0 0;
    the float32 nearest to 0.5 / 255 and 254.5 / 255 round as x * 255 in
    float32 then half to even make them."""
    vals = np.array([np.nan, np.inf, -np.inf, -0.0, np.nextafter(np.float32(1), np.float32(2)),
                     np.nextafter(np.float32(0), np.float32(-1)), 0.5 / 255, 254.5 / 255, 1.5 / 255],
                    np.float32)
    got = img_util.batch2img(vals.reshape(1, 1, 3, 3), rgb2bgr=True)[0, :, ::-1].ravel()
    half = (vals[6:] * np.float32(255)).round()
    assert list(got[:6]) == [0, 255, 0, 0, 255, 0]
    assert list(got[6:]) == list(half.astype(np.uint8))


def _unaligned_f32(x):
    """x's values in a float32 array that starts one byte into its buffer."""
    raw = np.zeros(x.nbytes + 1, np.uint8)
    out = np.frombuffer(raw.data, np.float32, x.size, offset=1).reshape(x.shape)
    assert not out.flags.aligned
    raw[1:] = x.view(np.uint8).ravel()
    return out


@pytest.mark.parametrize("case", ["float64", "min_max", "min_max_numpy_scalar", "rgb2bgr_off",
                                  "gray", "four_channels", "unaligned"])
def test_batch2img_inputs_the_native_pass_leaves_keep_numpy(case, numpy_route):
    rs = np.random.RandomState(5)
    x = (rs.rand(1, 12, 14, 3) * 1.4 - 0.2).astype(np.float32)
    arg, kw = {"float64": (x.astype(np.float64), {}),
               "min_max": (x, {"min_max": (-1, 1)}),
               "min_max_numpy_scalar": (x, {"min_max": (np.float64(0), np.float64(1))}),
               "rgb2bgr_off": (x, {"rgb2bgr": False}),
               "gray": (x[..., :1], {}),
               "four_channels": (np.concatenate([x, x[..., :1]], -1), {}),
               "unaligned": (_unaligned_f32(x), {})}[case]
    got, engaged = _engaged(img_util.batch2img, arg, **kw)
    assert engaged == 0
    np.testing.assert_array_equal(got, numpy_route(img_util.batch2img, arg, **kw))


@pytest.mark.parametrize("case", ["float32_input", "float64_input", "bgr2rgb_off", "float32_off",
                                  "gray"])
def test_img2batch_inputs_the_native_pass_leaves_keep_numpy(case, numpy_route):
    img = _u8(12, 14, 6)
    arg, kw = {"float32_input": (img.astype(np.float32) / 255, {}),
               "float64_input": (img / 255.0, {}),
               "bgr2rgb_off": (img, {"bgr2rgb": False}),
               "float32_off": (img, {"float32": False}),
               "gray": (img[..., 0], {})}[case]
    got, engaged = _engaged(img_util.img2batch, arg, **kw)
    assert engaged == 0
    np.testing.assert_array_equal(got, numpy_route(img_util.img2batch, arg, **kw))


def test_the_native_entry_points_refuse_what_they_cannot_read():
    with pytest.raises(ValueError, match=r"\(h, w, 3\)"):
        frames.bgr_u8_to_rgb_batch(_u8(4, 6)[..., :2])
    with pytest.raises(ValueError, match="float32"):
        frames.rgb_f32_to_bgr_u8(np.zeros((4, 6, 3)))
    with pytest.raises(ValueError, match="aligned"):
        frames.rgb_f32_to_bgr_u8(_unaligned_f32(np.zeros((4, 6, 3), np.float32)))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("name", ["img2batch", "batch2img"])
def test_conversions_open_their_span_once_on_either_route(name, route, numpy_route):
    """`wm.img2batch` / `wm.batch2img` wrap the whole call, on the native
    pass and on the numpy route alike."""
    arg = _u8(8, 10) if name == "img2batch" else np.random.RandomState(0).rand(1, 8, 10, 3).astype(
        np.float32)
    fn = getattr(img_util, name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if route == "native":
            _, engaged = _engaged(fn, arg)
            assert engaged == 1
        else:
            numpy_route(fn, arg)
    assert [e.name for e in prof.events() if e.name.startswith("wm.")] == [f"wm.{name}"]
