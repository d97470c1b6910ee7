"""The port's deployment artifacts (`wavemamba_torch/deploy.py`) on the CPU:
the counterparts of `tests/test_deploy.py` through the Python API, and the
port's `.wmt` against the JAX package's `.wmx` (the portable artifact and
uint8 ones are held against JAX's in `tests/test_torch_deploy_cli.py`, which
builds them through the CLI).

One seeded init of the JAX package is written to a `.pth` by its exporter;
the JAX side reads it back through `convert/torch_import.py`, the port reads
the same file. Most checks share one artifact (wf=8, (1, 1, 1) blocks,
buckets 32x32 and 64x32 and a tile program) exported with
`allow_custom_calls=True` for both devices, so each program holds K1's
registered op, which takes the plain version on a CPU tensor.

The artifact whose tile program is sharded over two ranks (`mesh_devices=2`)
is served by two gloo rank processes on the CPU
(`wavemamba_torch.scripts.multiproc_worker --checks artifact`), started once
by a module fixture, and held against the one-process artifact's tiles
within 1e-6 (each rank runs the batch-2 program on its half of every batch
of 4; the JAX package's `tests/test_deploy.py` holds its mesh at 2e-6).

Tolerances: a program's output equals the port's eager `wavemamba_forward`
bit for bit (the program is the same ops; the eager model's weights do not
require grad, as the program's inputs do not: on the CPU a convolution whose
weight requires grad takes another backend, ~1e-7 away). Against the JAX
artifacts, float32 agrees within 1e-5 (summation order, and JAX's 'chunked'
scan against the port's 'par' scan or K1's plain version); uint8 bytes agree
except where the two float outputs straddle a rounding half: by at most 1,
on at most 1e-3 of the values.
"""

import io
import json
import logging
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from wavemamba_torch import deploy
from wavemamba_torch.checkpoint import load_network
from wavemamba_torch.models import build_network
from wavemamba_torch.models.tiling import tiled_apply
from wavemamba_torch.models.wavemamba import WaveMambaConfig, wavemamba_forward
from wavemamba_torch.ops import scan_cuda
from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
from wavemamba_torch.parallel.dist import local_init_method
from wavemamba_torch.scripts import multiproc_worker as W

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SIZE = {"wf": 8, "n_l_blocks": (1, 1, 1), "n_h_blocks": (1, 1, 1)}
TILE = {"size": 16, "pad": 8, "batch": 4}  # a 32x32 tile program
ATOL = 1e-5
OPS_A_FORWARD = 2 * 2 * sum(SIZE["n_l_blocks"])  # two pairs an SS2D, down and up halves


def _image(seed, h, w, b=1):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _bytes(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (1, h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(port state dict, JAX params) of one seeded init, through one `.pth`."""
    from wavemamba_tpu.convert.torch_import import load_wavemamba_checkpoint
    from wavemamba_tpu.models.wavemamba import WaveMambaConfig as JaxConfig
    from wavemamba_tpu.models.wavemamba import init_wavemamba
    from wavemamba_tpu.train.checkpoint import export_to_pth

    pth = str(tmp_path_factory.mktemp("weights") / "net_g.pth")
    export_to_pth(init_wavemamba(jax.random.PRNGKey(0), JaxConfig(**SIZE)), pth)
    return load_network(pth, device="cpu"), load_wavemamba_checkpoint(pth)


@pytest.fixture(scope="module")
def eager(weights):
    """The port's eager model on the CPU, weights not requiring grad."""
    model = build_network({"type": "WaveMamba", **SIZE}, weights[0], device="cpu")
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("artifacts")


@pytest.fixture(scope="module")
def artifact(weights, workdir):
    """K1's op kept (`allow_custom_calls`), for both devices, served here."""
    path = workdir / "k1.wmt"
    deploy.export_model(weights[0], WaveMambaConfig(**SIZE), [(32, 32), (64, 32)], str(path),
                        allow_custom_calls=True, platforms=("cpu", "cuda"), tile=TILE)
    return deploy.load_exported(str(path), device="cpu")


@pytest.fixture(scope="module")
def bytes_artifact(weights, workdir):
    path = workdir / "u8.wmt"
    deploy.export_model(weights[0], WaveMambaConfig(**SIZE), [(32, 32)], str(path),
                        allow_custom_calls=True, platforms=("cpu", "cuda"), tile=TILE,
                        io_dtype="uint8")
    return deploy.load_exported(str(path), device="cpu")


@pytest.fixture(scope="module")
def weights_only(weights, workdir):
    """An artifact with no program: the manifest and the weights, for the
    loader's checks before it reads a program."""
    path = workdir / "none.wmt"
    deploy.export_model(weights[0], WaveMambaConfig(**SIZE), [], str(path))
    return path


@pytest.fixture(scope="module")
def jax_float32(weights, workdir):
    """The JAX package's float32 `.wmx` of the same weights."""
    from wavemamba_tpu.deploy import export_model, load_exported
    from wavemamba_tpu.models.wavemamba import WaveMambaConfig as JaxConfig

    path = str(workdir / "jax.wmx")
    export_model(weights[1], JaxConfig(**SIZE), [(32, 32)], path, platforms=("cpu",))
    return load_exported(path)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_ATOL = 1e-6


class _MeshRanks:
    """Two worker ranks started together; `results()` waits for them and
    loads each rank's pickle, in rank order."""

    def __init__(self, procs, out):
        self.procs, self.out, self._res = procs, out, None

    def results(self):
        import pickle

        if self._res is None:
            logs = [p.communicate(timeout=600)[0] for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._res = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                    self._res.append(pickle.load(f))
        return self._res


@pytest.fixture(scope="module")
def mesh_ranks(weights, workdir):
    """The float32 and uint8 artifacts with the tile program sharded over two
    ranks (no whole-frame bucket), served by two gloo ranks on the CPU."""
    for name, io_dtype in (("mesh", "float32"), ("mesh_u8", "uint8")):
        manifest = deploy.export_model(weights[0], WaveMambaConfig(**SIZE), [],
                                       str(workdir / f"{name}.wmt"), allow_custom_calls=True,
                                       platforms=("cpu", "cuda"), tile=TILE, mesh_devices=2,
                                       io_dtype=io_dtype)
    out = str(workdir / "ranks")
    init = local_init_method()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, "-m", "wavemamba_torch.scripts.multiproc_worker",
                               "--device", "cpu", "--init", init, "--world", "2", "--rank", str(r),
                               "--out", out, "--data", str(workdir), "--checks", "artifact"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    ranks = _MeshRanks(procs, out)
    yield manifest, ranks
    for p in procs:
        if p.poll() is None:
            p.kill()


# The mesh tests that do not wait for the ranks come first, so that the ranks
# run beside the tests below.


def test_mesh_tile_program_is_traced_at_the_rank_batch(mesh_ranks, workdir):
    """The program's input is the per-rank batch, (2, 32, 32, 3)."""
    manifest, _ = mesh_ranks
    model = deploy.load_exported(str(workdir / "mesh.wmt"), device="cpu")
    assert model.shapes == [] and model.manifest["tile_rank_batch"] == 2
    x_node = [n for n in model.runners["tile"].module.graph.nodes if n.op == "placeholder"][-1]
    assert tuple(x_node.meta["val"].shape) == (2, 32, 32, 3)


def test_mesh_tile_program_refuses_one_process(mesh_ranks, workdir):
    """Without a process group of `mesh_devices` ranks the sharded program
    raises, as JAX's raises on a host with too few devices; it never runs in
    one process."""
    model = deploy.load_exported(str(workdir / "mesh.wmt"), device="cpu")
    with pytest.raises(ValueError, match=r"exported for 2 devices.*no process group"):
        model.tiled(W.artifact_image()[0])


@pytest.mark.parametrize("length,out_dtype", [(200, None), (64, torch.bfloat16), (1, None)])
def test_fake_matches_the_plain_op(length, out_dtype):
    """`register_fake` gives the shapes and dtypes of what the op returns
    (the plain version on the CPU, K1's allocations on the card)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rs = np.random.RandomState(length)
    d, n, r = 16, 16, 1
    args = [torch.from_numpy(rs.rand(*s).astype(np.float32))
            for s in [(2, length, d), (2, d, r + 2 * n), (2, r, d), (2, d), (2, n, d), (2, d)]]
    args[4] = -args[4]
    real = scan_cuda.ss2d_scan_pair_fwd(*args, out_dtype)
    plain = ss2d_scan_pair_plain(*args, chunk=scan_cuda.CHUNK, return_carries=True,
                                 out_dtype=out_dtype)
    with FakeTensorMode() as mode:
        fake = scan_cuda.ss2d_scan_pair_fwd(*[mode.from_tensor(a) for a in args], out_dtype)
    for f, t, p in zip(fake, real, plain):
        assert (f.shape, f.dtype) == (t.shape, t.dtype) == (p.shape, p.dtype)


def test_op_route_is_the_eager_route(eager):
    """`ss2d_scan_pair_op` (the op under no_grad) gives the eager scan's bits."""
    from wavemamba_torch.models.wavemamba import set_scan

    x = torch.from_numpy(_image(3, 32, 32))
    with torch.no_grad():
        want = wavemamba_forward(eager, x)
        set_scan(eager, scan_cuda.ss2d_scan_pair_op)
        try:
            got = wavemamba_forward(eager, x)
        finally:
            set_scan(eager, scan_cuda.ss2d_scan_pair)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="K1 only"):
        scan_cuda.ss2d_scan_pair_op(*[None] * 6, variant="ssd")


def test_export_roundtrip_bit_exact(artifact, eager):
    """Each bucket's program equals the eager forward bit for bit, and holds
    K1's op once per direction pair."""
    m = artifact.manifest
    assert artifact.shapes == [(32, 32), (64, 32)]
    assert m["platforms"] == ["cpu", "cuda"] and m["config"]["scan_impl"] == "pallas_fused"
    assert m["torch_version"] == torch.__version__ and m["mesh_devices"] == 1
    assert m["n_params"] == len(eager.state_dict())
    for (h, w), seed in (((32, 32), 0), ((64, 32), 1)):
        x = _image(seed, h, w)
        with torch.no_grad():
            want = wavemamba_forward(eager, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(artifact(x), want)
        ops = [n for n in artifact.runners[(h, w)].module.graph.nodes
               if n.target is torch.ops.wavemamba_torch.ss2d_scan_pair_fwd.default]
        assert len(ops) == OPS_A_FORWARD


def test_exported_pad_crop_matches_direct(artifact, eager):
    """A 20x26 input rides the 32x32 program by reflect pad and crops back."""
    x = _image(1, 20, 26)
    got = artifact(x)
    assert got.shape == (1, 20, 26, 3)
    with torch.no_grad():
        want = wavemamba_forward(eager, torch.from_numpy(deploy._reflect_pad(x, 32, 32))).numpy()
    np.testing.assert_array_equal(got, want[:, :20, :26])
    # 40x30 fits only the 64x32 bucket.
    assert artifact(_image(2, 40, 30)).shape == (1, 40, 30, 3)


def test_exported_shape_and_batch_errors(artifact):
    with pytest.raises(ValueError, match="exceeds every exported shape"):
        artifact(np.zeros((1, 48, 48, 3), np.float32))
    with pytest.raises(ValueError, match="batch"):
        artifact(np.zeros((2, 16, 16, 3), np.float32))


def test_matches_jax_artifact_float32(artifact, jax_float32):
    """K1's op (its plain version here) against the JAX package's portable
    artifact, on a bucket's own shape and padded."""
    for seed, (h, w) in ((5, (32, 32)), (6, (17, 30))):
        x = _image(seed, h, w)
        np.testing.assert_allclose(artifact(x), jax_float32(x), atol=ATOL, rtol=0)


def test_exported_tile_program_matches_tiled_apply(artifact, weights_only, eager):
    m = artifact.manifest
    assert m["tile"] == {"size": 16, "pad": 8, "batch": 4, "pad_multiple": 8}
    # 40x56 exceeds every bucket: the whole-frame path refuses, tiled works.
    x = _image(3, 40, 56)
    with pytest.raises(ValueError, match="exceeds every exported shape"):
        artifact(x)
    got = artifact.tiled(x)
    assert got.shape == x.shape

    def fwd(z):
        with torch.no_grad():
            return wavemamba_forward(eager, torch.from_numpy(np.ascontiguousarray(z))).numpy()

    np.testing.assert_array_equal(got, tiled_apply(fwd, x, tile_size=16, tile_pad=8,
                                                   pad_multiple=8, tile_batch=4))
    with pytest.raises(ValueError, match="without a tile program"):
        deploy.load_exported(str(weights_only), device="cpu").tiled(x)


def test_cuda_pinned_export_builds_on_cpu_host(weights, workdir):
    """allow_custom_calls narrows the default platforms to the card, and the
    program with K1's op traces on a host without one; serving it on the CPU
    fails with a message that names its platforms (loading is fine)."""
    path = workdir / "pinned.wmt"
    manifest = deploy.export_model(weights[0], WaveMambaConfig(**SIZE), [(32, 32)], str(path),
                                   allow_custom_calls=True)
    assert manifest["platforms"] == ["cuda"]
    assert manifest["config"]["scan_impl"] == "pallas_fused"
    model = deploy.load_exported(str(path), device="cpu")
    with pytest.raises(ValueError, match=r"exported for platform\(s\) \['cuda'\].*'cpu'"):
        model(_image(0, 32, 32))
    with pytest.raises(ValueError, match="platform"):
        model.dispatch(_image(0, 32, 32))


def test_export_refuses_what_has_no_op(weights, workdir):
    """The mesh-sharded tile program takes JAX's checks (a tile spec, a tile
    batch that divides over the devices); the fused conv chains and K3 / K4
    have no registered op."""
    sd, path = weights[0], str(workdir / "x.wmt")
    with pytest.raises(ValueError, match="shards the tile program"):
        deploy.export_model(sd, WaveMambaConfig(**SIZE), [(32, 32)], path, mesh_devices=2)
    with pytest.raises(ValueError, match="must divide"):
        deploy.export_model(sd, WaveMambaConfig(**SIZE), [(32, 32)], path,
                            tile={"size": 16, "pad": 8, "batch": 3}, mesh_devices=2)
    with pytest.raises(NotImplementedError, match="conv_impl='fused'"):
        deploy.export_model(sd, WaveMambaConfig(conv_impl="fused", **SIZE), [(32, 32)], path)
    with pytest.raises(NotImplementedError, match="K3 / K4"):
        deploy.export_model(sd, WaveMambaConfig(scan_impl="pallas", **SIZE), [(32, 32)], path,
                            allow_custom_calls=True)
    with pytest.raises(ValueError, match="platforms"):
        deploy.export_model(sd, WaveMambaConfig(**SIZE), [(32, 32)], path, platforms=("tpu",))


def test_checksum_guards_weight_payload(weights_only, tmp_path):
    path = weights_only
    deploy.load_exported(str(path), device="cpu")  # the intact artifact loads
    bad = tmp_path / "bad.wmt"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "params.npz":
                with np.load(io.BytesIO(data)) as npz:
                    arrs = {k: npz[k].copy() for k in npz.files}
                arrs["p000000"].flat[0] += 1.0
                buf = io.BytesIO()
                np.savez(buf, **arrs)
                data = buf.getvalue()
            zout.writestr(name, data)
    with pytest.raises(ValueError, match="checksum"):
        deploy.load_exported(str(bad), device="cpu")


def test_uint8_io_matches_save_path_quantization(artifact, bytes_artifact):
    """uint8 programs give batch2img's quantization of the float program's
    output, whole-frame and tiled; float input is quantized on the host."""
    m8 = bytes_artifact
    assert m8.io_dtype == "uint8" and artifact.io_dtype == "float32"
    x = _bytes(11, 20, 26)
    got = m8(x)
    assert got.dtype == np.uint8
    want = np.round(np.clip(artifact(x.astype(np.float32) / 255.0), 0, 1) * 255.0)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    np.testing.assert_array_equal(m8(x.astype(np.float32) / 255.0), got)
    big = _bytes(12, 40, 56)
    got_t = m8.tiled(big)
    assert got_t.dtype == np.uint8 and got_t.shape == big.shape
    want_t = np.round(np.clip(artifact.tiled(big.astype(np.float32) / 255.0), 0, 1) * 255.0)
    assert int(np.abs(got_t.astype(int) - want_t.astype(int)).max()) <= 1


def test_dispatch_fetch_matches_call(artifact):
    """Two dispatches in flight fetch what blocking calls give."""
    xs = [_image(s, 20, 26) for s in (5, 6)]
    handles = [artifact.dispatch(x) for x in xs]
    for x, h in zip(xs, handles):
        np.testing.assert_array_equal(h.fetch(), artifact(x))


def test_loader_warns_on_torch_version_drift(weights_only, tmp_path, caplog, monkeypatch):
    """The manifest records the exporting torch; loading under another logs
    a warning (and loads); a same-version load is silent. (The port's
    `utils/logger.py` stops the package's logger propagating once a pipeline
    has set it up in this process, so the test lets it propagate.)"""
    monkeypatch.setattr(logging.getLogger("wavemamba_torch"), "propagate", True)
    with zipfile.ZipFile(weights_only) as zf:
        payload = {n: zf.read(n) for n in zf.namelist()}
    manifest = json.loads(payload["manifest.json"])
    manifest["torch_version"] = "0.0.1-ancient"
    payload["manifest.json"] = json.dumps(manifest).encode()
    drifted = tmp_path / "drifted.wmt"
    with zipfile.ZipFile(drifted, "w") as zf:
        for n, data in payload.items():
            zf.writestr(n, data)
    with caplog.at_level(logging.WARNING, logger="wavemamba_torch"):
        model = deploy.load_exported(str(drifted), device="cpu")
    assert any("0.0.1-ancient" in r.message for r in caplog.records)
    assert model.manifest["n_params"] == manifest["n_params"]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="wavemamba_torch"):
        deploy.load_exported(str(weights_only), device="cpu")
    assert not [r for r in caplog.records if "exported with torch" in r.message]


def test_wmx_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match=r"JAX package.*\.wmt"):
        deploy.load_exported(str(tmp_path / "model.wmx"), device="cpu")


def test_loading_for_the_card_raises_without_one(weights_only, monkeypatch):
    """The entry points serve on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy.load_exported(str(weights_only))


def test_compile_cache_is_the_kernels_build_directory(tmp_path, monkeypatch):
    """`enable_compilation_cache` points every kernel build at its directory:
    the first build there runs the compiler, a later one (another process's)
    finds the library by its source's hash and runs nothing. Checked with a
    stand-in for nvcc."""
    monkeypatch.setattr(scan_cuda, "BUILD_DIR", scan_cuda.BUILD_DIR)
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return type("Done", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(scan_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(scan_cuda.subprocess, "run", fake_nvcc)
    cache = deploy.enable_compilation_cache(tmp_path / "cache")
    assert scan_cuda.BUILD_DIR == cache == (tmp_path / "cache").resolve()
    first = scan_cuda.build(scan_cuda.SOURCE)
    assert first.parent == cache and first.exists() and len(runs) == 1
    assert scan_cuda.build(scan_cuda.SOURCE) == first and len(runs) == 1


def test_mesh_sharded_tile_program_matches_one_process(mesh_ranks, artifact, bytes_artifact):
    """mesh_devices=2: each rank runs the batch-2 tile program on its half of
    every batch of 4, the halves gathered in rank order; both ranks return
    the whole frame, within 1e-6 of the one-process artifact's tiles and the
    same bits on both ranks (uint8: the same bytes)."""
    manifest, ranks = mesh_ranks
    assert manifest["mesh_devices"] == 2 and manifest["tile"]["batch"] == 4
    assert manifest["tile_rank_batch"] == 2
    res = ranks.results()
    x, x8 = W.artifact_image()
    want, want8 = artifact.tiled(x), bytes_artifact.tiled(x8)
    for r in res:
        assert r["artifact_mesh"].shape == x.shape
        np.testing.assert_allclose(r["artifact_mesh"], want, atol=MESH_ATOL, rtol=0)
        assert r["artifact_mesh_u8"].dtype == np.uint8
        np.testing.assert_array_equal(r["artifact_mesh_u8"], want8)
        assert r["artifact_mesh_replays"] == 0  # the CPU runs the program as it is, no graph
    np.testing.assert_array_equal(res[0]["artifact_mesh"], res[1]["artifact_mesh"])
