"""The port's deployment CLI (`python -m wavemamba_torch.scripts.export_model`)
and `python -m wavemamba_torch.inference -w <artifact>` on the CPU: the
counterparts of `tests/test_deploy.py`'s CLI tests, and the artifacts the CLI
builds held against the JAX package's `.wmx` of the same weights (see
`tests/test_torch_deploy.py` for the tolerances).

The weights are one seeded init of the JAX package written to a `.pth` by
its exporter (the CLIs' `-w`); the JAX side reads it back through
`convert/torch_import.py`.
"""

import json
import os
import zipfile

import cv2
import jax
import numpy as np
import pytest
import torch

from wavemamba_torch import deploy
from wavemamba_torch.scripts.export_model import main as cli
from wavemamba_torch.utils import cxx

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SIZE = {"wf": 8, "n_l_blocks": (1, 1, 1), "n_h_blocks": (1, 1, 1)}
SIZE_FLAGS = ["--wf", "8", "--n_l_blocks", "1", "1", "1", "--n_h_blocks", "1", "1", "1"]
ATOL = 1e-5


def _manifest(path):
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("manifest.json"))


def _folder(path, sizes, seed=0, scale=1.0):
    os.makedirs(path)
    rs = np.random.RandomState(seed)
    for name, (h, w) in sizes.items():
        cv2.imwrite(str(path / name), (rs.randint(0, 255, (h, w, 3)) * scale).astype(np.uint8))
    return path


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def pth(workdir):
    from wavemamba_tpu.models.wavemamba import WaveMambaConfig as JaxConfig
    from wavemamba_tpu.models.wavemamba import init_wavemamba
    from wavemamba_tpu.train.checkpoint import export_to_pth

    path = str(workdir / "net_g.pth")
    export_to_pth(init_wavemamba(jax.random.PRNGKey(0), JaxConfig(**SIZE)), path)
    return path


@pytest.fixture(scope="module")
def jax_wmx(pth, workdir):
    """The JAX package's float32 and uint8 `.wmx` of the same weights."""
    from wavemamba_tpu.convert.torch_import import load_wavemamba_checkpoint
    from wavemamba_tpu.deploy import export_model, load_exported
    from wavemamba_tpu.models.wavemamba import WaveMambaConfig as JaxConfig

    params = load_wavemamba_checkpoint(pth)
    out = {}
    for io_dtype in ("float32", "uint8"):
        path = str(workdir / f"jax_{io_dtype}.wmx")
        export_model(params, JaxConfig(**SIZE), [(32, 32)], path, platforms=("cpu",),
                     io_dtype=io_dtype)
        out[io_dtype] = load_exported(path)
    return out


@pytest.fixture(scope="module")
def portable(pth, workdir):
    """`export` with its defaults: the portable artifact ('par' scan)."""
    art = workdir / "par.wmt"
    cli(["export", "-w", pth, "-o", str(art), "--shapes", "32x32"] + SIZE_FLAGS)
    return art


@pytest.fixture(scope="module")
def bytes_k1(pth, workdir):
    """`export --io uint8 --allow_custom_calls --platforms cpu cuda`."""
    art = workdir / "u8.wmt"
    cli(["export", "-w", pth, "-o", str(art), "--shapes", "32x32", "--io", "uint8",
         "--allow_custom_calls", "--platforms", "cpu", "cuda"] + SIZE_FLAGS)
    return art


@pytest.fixture(scope="module")
def mesh_wmt(pth, workdir):
    """`export --tile 16 --tile_pad 8 --tile_batch 4 --mesh_devices 2`, K1's
    op kept for both devices (its programs trace and load in a third of the
    portable 'par' programs' time): the tile program sharded over two ranks."""
    art = workdir / "mesh.wmt"
    cli(["export", "-w", pth, "-o", str(art), "--shapes", "32x32", "--tile", "16", "--tile_pad",
         "8", "--tile_batch", "4", "--mesh_devices", "2", "--allow_custom_calls", "--platforms",
         "cpu", "cuda"] + SIZE_FLAGS)
    return art


def test_export_cli_serves_folder(portable, tmp_path, monkeypatch):
    """export -> run: the serving path touches only deploy.py, K1's op and
    image I/O; `--compile_cache` points every build there (`cxx.BUILD_DIR`)."""
    monkeypatch.setattr(cxx, "BUILD_DIR", cxx.BUILD_DIR)
    lq = _folder(tmp_path / "lq", {"a.png": (20, 26), "b.png": (32, 32)})
    out_dir = tmp_path / "served"
    cli(["run", "-a", str(portable), "-i", str(lq), "-o", str(out_dir), "--device", "cpu",
         "--compile_cache", str(tmp_path / "kernels")])
    assert sorted(os.listdir(out_dir)) == ["a.png", "b.png"]
    assert cv2.imread(str(out_dir / "a.png")).shape == (20, 26, 3)
    assert cxx.BUILD_DIR == (tmp_path / "kernels").resolve()


def test_export_swaps_pallas_for_portable_lowering(portable, jax_wmx):
    """The default artifact takes the plain 'par' scan (no op node), serves
    on both devices, and agrees with the JAX package's portable artifact."""
    model = deploy.load_exported(str(portable), device="cpu")
    assert model.manifest["config"]["scan_impl"] == "par"
    assert model.manifest["platforms"] == ["cpu", "cuda"]
    assert not [n for n in model.runners[(32, 32)].module.graph.nodes
                if "ss2d_scan_pair_fwd" in str(n.target)]
    for seed, (h, w) in ((4, (20, 26)), (5, (32, 32))):
        x = np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)
        out = model(x)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, jax_wmx["float32"](x), atol=ATOL, rtol=0)


def test_export_cli_uint8_serves_folder(bytes_k1, tmp_path):
    """Bytes-only serving through the CLI, K1's op on its plain version."""
    lq = _folder(tmp_path / "lq", {"a.png": (20, 26)})
    out_dir = tmp_path / "served"
    cli(["run", "-a", str(bytes_k1), "-i", str(lq), "-o", str(out_dir), "--device", "cpu"])
    assert cv2.imread(str(out_dir / "a.png")).shape == (20, 26, 3)


def test_uint8_matches_jax_artifact(bytes_k1, jax_wmx):
    """Bytes equal the JAX package's, except at rounding halves: at most 1,
    on at most 1e-3 of the values."""
    model = deploy.load_exported(str(bytes_k1), device="cpu")
    assert model.manifest["io_dtype"] == "uint8"
    for seed, (h, w) in ((7, (32, 32)), (8, (20, 26))):
        x = np.random.RandomState(seed).randint(0, 256, (1, h, w, 3), np.uint8)
        got, want = model(x), jax_wmx["uint8"](x)
        assert got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_export_cli_target_cuda_builds_pinned_fast_preset(pth, mesh_wmt, tmp_path):
    """`--fast --target cuda --allow_custom_calls` on a host without a card
    bakes the card's bf16 preset with K1's op; `run` on the CPU refuses it,
    naming its platforms; `--mesh_devices 2` is passed through to the
    manifest, and without `--tile` it raises JAX's error."""
    art = tmp_path / "pinned.wmt"
    cli(["export", "-w", pth, "-o", str(art), "--shapes", "32x32", "--fast", "--target", "cuda",
         "--allow_custom_calls", "--io", "uint8"] + SIZE_FLAGS)
    manifest = _manifest(art)
    assert manifest["config"]["scan_impl"] == "pallas_fused"
    assert manifest["config"]["compute_dtype"] == manifest["config"]["scan_dtype"] == "bfloat16"
    assert manifest["platforms"] == ["cuda"]
    assert manifest["io_dtype"] == "uint8"
    lq = _folder(tmp_path / "lq", {"a.png": (20, 26)})
    with pytest.raises(ValueError, match=r"\['cuda'\].*'cpu'"):
        cli(["run", "-a", str(art), "-i", str(lq), "-o", str(tmp_path / "o"), "--device", "cpu"])
    manifest = _manifest(mesh_wmt)
    assert manifest["mesh_devices"] == 2 and manifest["tile"]["batch"] == 4
    assert manifest["tile_rank_batch"] == 2
    with pytest.raises(ValueError, match="shards the tile program"):
        cli(["export", "-w", pth, "-o", str(tmp_path / "m.wmt"), "--shapes", "32x32",
             "--mesh_devices", "2"] + SIZE_FLAGS)


def test_inference_cli_accepts_wmt_artifact(pth, tmp_path, capsys):
    """`inference -w model.wmt` serves from the artifact, whole-frame and
    through its tile program (`--tile`), with GT metrics; the whole-frame
    output is the `.pth` route's within one level."""
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.inference import main as infer_main
    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    art = tmp_path / "m.wmt"
    deploy.export_model(load_network(pth, device="cpu"), WaveMambaConfig(**SIZE), [(128, 128)],
                        str(art), allow_custom_calls=True, platforms=("cpu", "cuda"),
                        tile={"size": 16, "pad": 8, "batch": 4})
    img = np.random.RandomState(0).randint(0, 255, (40, 48, 3), np.uint8)
    lq, gt = tmp_path / "lq", tmp_path / "gt"
    os.makedirs(lq)
    os.makedirs(gt)
    cv2.imwrite(str(lq / "a.png"), (img * 0.2).astype(np.uint8))
    cv2.imwrite(str(gt / "a.png"), img)
    outs = {}
    for name, extra in (("art", ["-w", str(art)]), ("tiled", ["-w", str(art), "--tile", "16"]),
                        ("pth", ["-w", pth] + SIZE_FLAGS)):
        infer_main(["-i", str(lq), "-g", str(gt), "-o", str(tmp_path / name), "--device", "cpu"]
                   + extra)
        out = capsys.readouterr().out
        assert "psnr" in out and "avg psnr" in out, out
        outs[name] = cv2.imread(str(tmp_path / name / "a.png")).astype(int)
        assert outs[name].shape == (40, 48, 3)
    assert np.abs(outs["art"] - outs["pth"]).max() <= 1


def test_inference_serves_a_mesh_artifact_under_torchrun(pth, mesh_wmt, tmp_path):
    """`torchrun --nproc_per_node=2 -m wavemamba_torch.inference -w mesh.wmt
    --tile 16` on two gloo CPU ranks: rank 0 alone prints and writes, and
    the image is the one-process tiles' (the eager model, K1's plain
    version on the CPU as in the artifact, batches of 4) within one level."""
    import subprocess
    import sys

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.tiling import tiled_apply
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.utils.img_util import batch2img, img2batch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lq = _folder(tmp_path / "lq", {"a.png": (40, 56)}, seed=3)
    gt = _folder(tmp_path / "gt", {"a.png": (40, 56)}, seed=4)
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", "-m", "wavemamba_torch.inference", "-w",
                           str(mesh_wmt), "-i", str(lq), "-g", str(gt), "-o", str(out), "--tile",
                           "16", "--device", "cpu"], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sum(ln.startswith("a.png:") for ln in proc.stdout.splitlines()) == 1, proc.stdout
    assert "avg psnr" in proc.stdout
    assert os.listdir(out) == ["a.png"]
    model = build_network({"type": "WaveMamba", **SIZE},
                          load_network(pth, device="cpu"), device="cpu")
    img = img2batch(cv2.imread(str(lq / "a.png")))
    want = batch2img(tiled_apply(lambda t: wavemamba_apply(model, torch.from_numpy(t)).numpy(), img,
                                 tile_size=16, tile_pad=8, tile_batch=4))
    got = cv2.imread(str(out / "a.png"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
