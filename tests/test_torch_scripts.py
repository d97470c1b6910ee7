"""The port's scripts (`python -m wavemamba_torch.scripts.<name>`) against the
JAX repo's `scripts/` and the JAX package on the CPU, at a tiny size.

`dataset_manifest`, `merge_datasets` and `metrics_sweep` give the JAX
scripts' bytes, rows and CSV; `trace_topops` gives an exact table for a
hand-made trace and refuses a trace with no device event; `cross_val_ckpts`,
`tiled_localize` and `post_train_eval` run a tiny `.pth` through the port and
are held against JAX's `wavemamba_apply` / `tiled_apply` on the same `.pth`
within 1e-5; `eval_run_ckpts` against the JAX runner's validation of the same
weights; `conv1x1_sweep` runs here at a tiny size for its output, and
`chain_tune`, a sweep of a card-only kernel, refuses to run without a card.
No new script module imports JAX.
"""

import ast
import contextlib
import csv
import importlib.util
import io
import json
import logging
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from wavemamba_torch import convert
from wavemamba_torch.models.wavemamba import WaveMambaConfig
from wavemamba_torch.scripts import (
    chain_tune,
    common,
    conv1x1_sweep,
    cross_val_ckpts,
    dataset_manifest,
    eval_run_ckpts,
    merge_datasets,
    metrics_sweep,
    post_train_eval,
    tiled_fidelity,
    tiled_localize,
    trace_topops,
)
from wavemamba_tpu import data as jdata
from wavemamba_tpu import runner as jrunner
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.models.tiling import tiled_apply as jtiled_apply
from wavemamba_tpu.train.checkpoint import load_network as jload_network

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
ARCH_FLAGS = ["--wf", "8", "--n_l_blocks", "1", "1", "1", "--n_h_blocks", "1", "1", "1"]
NEW_MODULES = ["dataset_manifest", "merge_datasets", "metrics_sweep", "trace_topops",
               "cross_val_ckpts", "tiled_localize", "eval_run_ckpts", "post_train_eval",
               "conv1x1_sweep", "tiled_fidelity", "chain_tune", "common"]


def _jax_script(name):
    """The JAX repo's `scripts/<name>.py` as a module (its own directory on
    sys.path, as when it runs)."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(os.path.dirname(path))
    return module


def _captured(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def _pth(tmp_path, seed=0, name="w.pth"):
    """A tiny WaveMamba `.pth` from JAX's init (the reference's layout)."""
    params = jwm.init_wavemamba(jax.random.PRNGKey(seed), jwm.WaveMambaConfig(**SMALL))
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    path = str(tmp_path / name)
    torch.save({"params": sd}, path)
    return path


def _write_pairs(root, n=2, shape=(32, 40), seed=0):
    """`root/input` and `root/gt` with n low-light / bright PNG pairs."""
    rs = np.random.RandomState(seed)
    for sub in ("input", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        gt = (rs.rand(*shape, 3) * 255).astype(np.uint8)
        lq = (gt * 0.2).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "gt", f"{i:03d}.png"), gt)
        cv2.imwrite(os.path.join(root, "input", f"{i:03d}.png"), lq)


def _jax_forward(path, img):
    cfg = jwm.WaveMambaConfig(**SMALL)
    params = jload_network(path)
    return np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, cfg, t))(params, img))


def _tree(root, files):
    for rel, data in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


# ---------------------------------------------------------------- manifests

def _dataset(root):
    _tree(root, {f"{split}/{sub}/{i:05d}.png": f"{split}{sub}{i}".encode() * 7
                 for split in ("train", "val") for sub in ("gt", "input") for i in range(3)})


def test_dataset_manifest_writes_the_jax_bytes_and_each_verifies_the_other(tmp_path):
    jscript = _jax_script("dataset_manifest")
    _dataset(tmp_path / "d")
    args = "--bsrgan --seed 2 --n-train 3 --n-val 3 --size 512"
    _captured(dataset_manifest.main, ["write", str(tmp_path / "d"), "--generator-args", args,
                                       "--note", "unit"])
    ours = (tmp_path / "d" / "MANIFEST.json").read_bytes()
    jscript.write(str(tmp_path / "d"), args, "unit")
    assert (tmp_path / "d" / "MANIFEST.json").read_bytes() == ours
    assert json.loads(ours)["generator"] == "scripts/make_proc_dataset.py"
    # the JAX script wrote last: the port verifies it; then the port's, under JAX
    ok, text = _captured(dataset_manifest.verify, str(tmp_path / "d"))
    assert ok and text.startswith("ok: 12 files")
    _captured(dataset_manifest.main, ["write", str(tmp_path / "d"), "--generator-args", args,
                                       "--note", "unit"])
    assert _captured(jscript.verify, str(tmp_path / "d"), "val")[0]
    assert _captured(dataset_manifest.verify, str(tmp_path / "d"), "val")[1].startswith("ok: 6")


@pytest.mark.parametrize("fault", ["modified", "missing"])
def test_dataset_manifest_verify_exits_1(tmp_path, fault):
    _dataset(tmp_path / "d")
    _captured(dataset_manifest.main, ["write", str(tmp_path / "d")])
    victim = tmp_path / "d" / "val" / "gt" / "00001.png"
    if fault == "modified":
        data = bytearray(victim.read_bytes())
        data[0] ^= 1
        victim.write_bytes(bytes(data))
    else:
        victim.unlink()
    run = subprocess.run([sys.executable, "-m", "wavemamba_torch.scripts.dataset_manifest",
                          "verify", str(tmp_path / "d")], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert run.returncode == 1, run.stdout + run.stderr
    assert run.stdout.startswith(f"FAIL: {int(fault == 'modified')} modified, "
                                 f"{int(fault == 'missing')} missing")
    # the train split is intact
    assert _captured(dataset_manifest.verify, str(tmp_path / "d"), "train")[0]


def test_shipped_manifests_have_the_format(tmp_path):
    """The MANIFEST.json files in datasets/ (their pixels are not in the
    repository) carry the keys and generator name the port's script writes."""
    paths = sorted(p for p in (os.path.join(REPO, "datasets", d, "MANIFEST.json")
                               for d in os.listdir(os.path.join(REPO, "datasets")))
                   if os.path.exists(p))
    assert paths
    _dataset(tmp_path / "d")
    ours = dataset_manifest.build_manifest(str(tmp_path / "d"), "--seed 1")
    for path in paths:
        with open(path) as f:
            manifest = json.load(f)
        assert set(manifest) == set(ours), path
        assert manifest["generator"] == ours["generator"] == "scripts/make_proc_dataset.py"
        assert manifest["n_files"] == len(manifest["files"])


def test_merge_datasets_makes_the_jax_tree_and_manifest(tmp_path):
    for i, src in enumerate(("a", "b")):
        _tree(tmp_path / src, {f"train/{sub}/{name}.png": f"{src}{sub}{name}".encode()
                               for sub in ("gt", "input") for name in ("x", "y", "z")[:2 + i]})
    sources = [str(tmp_path / "a"), str(tmp_path / "b")]
    _captured(merge_datasets.main, [*sources, "--out", str(tmp_path / "ours")])
    jax_run = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "merge_datasets.py"),
                              *sources, "--out", str(tmp_path / "theirs")], capture_output=True,
                             text=True)
    assert jax_run.returncode == 0, jax_run.stderr
    ours, theirs = (jdata_tree(tmp_path / d) for d in ("ours", "theirs"))
    assert ours == theirs and len(ours) == 2 * 5 + 1
    assert json.loads(ours["MANIFEST.json"])["n_files"] == 10
    # hardlinks: the merged file is the source's inode
    assert os.stat(tmp_path / "ours" / "train" / "gt" / "00002.png").st_ino == \
        os.stat(tmp_path / "b" / "train" / "gt" / "x.png").st_ino


def jdata_tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# ---------------------------------------------------------------- metrics

def test_metrics_sweep_gives_the_jax_rows_and_csv(tmp_path):
    _write_pairs(str(tmp_path), n=3)
    os.remove(tmp_path / "gt" / "002.png")  # one prediction without GT: skipped by both
    args = ["-p", str(tmp_path / "input"), "-g", str(tmp_path / "gt"), "-m", "psnr", "ssim",
            "--crop_border", "2", "--y_channel"]
    rows, text = _captured(metrics_sweep.main, [*args, "-o", str(tmp_path / "ours.csv"),
                                                "--device", "cpu"])
    _, jtext = _captured(_jax_script("metrics_sweep").main, [*args, "-o", str(tmp_path / "j.csv")])
    assert len(rows) == 2 and text.replace("ours.csv", "j.csv") == jtext
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    with open(tmp_path / "ours.csv") as f:
        assert [r["name"] for r in csv.DictReader(f)] == ["000.png", "001.png"]


def test_metrics_sweep_builds_lpips_before_reading_images(tmp_path):
    """As the inference CLI: lpips without weights, or with a missing file,
    fails before any image is read (here there is no image folder at all)."""
    with pytest.raises(ValueError, match="weights_path"):
        metrics_sweep.main(["-p", str(tmp_path / "none"), "-m", "lpips", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        metrics_sweep.main(["-p", str(tmp_path / "none"), "-m", "lpips", "--lpips_weights",
                            str(tmp_path / "missing.pth"), "--device", "cpu"])


# ---------------------------------------------------------------- traces

def _event(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0, "dur": dur}


def test_trace_topops_table_of_a_hand_made_trace(tmp_path):
    events = [
        _event("void (anonymous namespace)::chunk_scan<16, 2, false, float, float>(Params)", "kernel",
               1500.0),
        _event("void chunk_scan<16, 2, true, float, float>(Params)", "kernel", 500.0),
        _event("chunk_prefix(float const*, int)", "kernel", 1000.0),
        _event("void at::native::(anonymous namespace)::elementwise_kernel<128, 4>(int)", "kernel",
               250.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 750.0),
        _event("aten::conv2d", "cpu_op", 9000.0),
        _event("cudaLaunchKernel", "cuda_runtime", 9000.0),
        _event("chunk_prefix(float const*, int)", "kernel", 1000.0, ph="i"),  # not a complete event
    ]
    (tmp_path / "logs").mkdir()
    with open(tmp_path / "logs" / "trace_1_2.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    (per_op, total, calls), text = _captured(trace_topops.main, str(tmp_path / "logs"), 2)
    assert total == pytest.approx(4.0)
    assert dict(per_op) == pytest.approx({"chunk_scan": 2.0, "chunk_prefix": 1.0,
                                          "at::native::elementwise_kernel": 0.25,
                                          "Memcpy HtoD": 0.75})
    assert dict(calls) == {"chunk_scan": 2, "chunk_prefix": 1,
                           "at::native::elementwise_kernel": 1, "Memcpy HtoD": 1}
    lines = text.splitlines()
    assert lines[1] == "# total device op time: 4.0 ms (2.0 ms/iter over 2 iters)"
    assert lines[4].split() == ["chunk_scan", "1.00", "1", "50.0%"]
    assert lines[5].split() == ["chunk_prefix", "0.50", "0", "25.0%"]
    assert len(lines) == 4 + 4


def test_trace_topops_refuses_a_trace_without_device_events(tmp_path):
    """A real trace of `utils/profiler.trace` on the CPU: host events only."""
    from wavemamba_torch.utils import profiler

    with profiler.trace(str(tmp_path)):
        torch.nn.functional.conv2d(torch.rand(1, 3, 8, 8), torch.rand(4, 3, 3, 3))
    assert len(os.listdir(tmp_path)) == 1
    with pytest.raises(ValueError, match="no device event"):
        trace_topops.main(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        trace_topops.main(str(tmp_path / "empty_dir_that_is_missing"))


# ---------------------------------------------------------------- checkpoints

def test_cross_val_ckpts_matches_jax_on_a_tiny_pth(tmp_path):
    path = _pth(tmp_path)
    _write_pairs(str(tmp_path / "set" / "val"), n=2)
    table, text = _captured(cross_val_ckpts.main, [
        "--ckpt", f"k={path}", "--ckpt", f"gone={tmp_path / 'missing.pth'}",
        "--val_root", str(tmp_path / "set"), "--val_root", str(tmp_path / "empty"),
        "-n", "2", *ARCH_FLAGS, "--device", "cpu"])
    assert "skip ckpt gone" in text and "skip empty" in text and text.rstrip().endswith("DONE")
    model = common.load_model(path, WaveMambaConfig(**SMALL), "cpu")
    vals = []
    for i in range(2):
        x = common.read_rgb(str(tmp_path / "set" / "val" / "input" / f"{i:03d}.png"))
        gt = common.read_rgb(str(tmp_path / "set" / "val" / "gt" / f"{i:03d}.png"))
        got, want = common.restore(model, x), _jax_forward(path, x[None])[0]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        vals.append(common.psnr(np.clip(want, 0, 1), gt))
    assert list(table) == [("set", "k")]
    assert table[("set", "k")] == pytest.approx(float(np.mean(vals)), abs=1e-4)


def test_tiled_localize_matches_jax_tiles(tmp_path):
    path = _pth(tmp_path)
    _write_pairs(str(tmp_path / "val"), n=1, shape=(72, 80))
    img = common.read_rgb(str(tmp_path / "val" / "input" / "000.png"))
    x = np.ascontiguousarray(img[None, :64, :64])
    model = common.load_model(path, WaveMambaConfig(**SMALL), "cpu")
    whole, out = tiled_localize.localize(model, x, [32])
    cfg = jwm.WaveMambaConfig(**SMALL)
    params = jload_network(path)
    fwd = jax.jit(lambda t: jwm.wavemamba_apply(params, cfg, t))
    np.testing.assert_allclose(whole, np.asarray(fwd(x)), atol=1e-5, rtol=0)
    jtiled = jtiled_apply(fwd, x, tile_size=32, tile_pad=16, pad_multiple=8, tile_batch=4)
    np.testing.assert_allclose(out[32][0], jtiled, atol=1e-5, rtol=0)
    rows, text = _captured(tiled_localize.main, [
        "--ckpt", path, "--input", str(tmp_path / "val" / "input" / "000.png"), "--crop", "64",
        "--tiles", "32", *ARCH_FLAGS, "--device", "cpu"])
    assert rows[32] == out[32][1] and text.startswith("tile=32: PSNR ")


def test_post_train_eval_writes_a_pth_jax_loads(tmp_path):
    exp = tmp_path / "exp"
    src = _pth(tmp_path, seed=3)
    os.makedirs(exp / "models")
    os.replace(src, exp / "models" / "net_g_best_latest.pth")
    (exp / "train_unit_1.log").write_text("iter 1 psnr: 10.0\nno metric here\niter 2 psnr: 11.0\n")
    _write_pairs(str(tmp_path / "val"), n=2)
    out = str(tmp_path / "out" / "w.pth")
    rows, text = _captured(post_train_eval.main, [
        "--exp", str(exp), "--out", out, "--val", str(tmp_path / "val"), "--prefix", "unit",
        "--samples_dir", str(tmp_path / "samples"), *ARCH_FLAGS, "--device", "cpu"])
    lines = text.splitlines()
    assert lines[:2] == ["iter 1 psnr: 10.0", "iter 2 psnr: 11.0"]
    assert "strict load ok" in lines and lines[-1] == "DONE"
    assert sorted(os.listdir(tmp_path / "samples")) == [
        f"unit_{i:02d}_{k}.png" for i in range(2) for k in ("input", "restored")]
    assert [r["max_abs_vs_cpu"] for r in rows] == [0.0, 0.0]
    saved = torch.load(out, map_location="cpu")
    assert list(saved) == ["params"]
    img = common.read_rgb(str(tmp_path / "val" / "input" / "000.png"))
    want = _jax_forward(out, img[None])[0]  # JAX's load_network reads the written file
    got = common.restore(common.load_model(out, WaveMambaConfig(**SMALL), "cpu"), img)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    gt = common.read_rgb(str(tmp_path / "val" / "gt" / "000.png"))
    assert rows[0]["psnr_out"] == pytest.approx(common.psnr(np.clip(want, 0, 1), gt), abs=1e-4)


def test_eval_run_ckpts_matches_the_jax_runner_validation(tmp_path, monkeypatch):
    _write_pairs(str(tmp_path / "val"), n=2)
    net = {"type": "WaveMamba", "in_chn": 3, **{k: list(v) if isinstance(v, tuple) else v
                                                 for k, v in SMALL.items()},
           "ffn_scale": 2.0, "scan_impl": "chunked"}
    opt = {"name": "unit", "model_type": "FeMaSRModel", "manual_seed": 0,
           "network_g": net,
           "datasets": {"val": {"name": "unit_val", "type": "PairedImageDataset",
                                "dataroot_gt": "val/gt", "dataroot_lq": "val/input",
                                "io_backend": {"type": "disk"}}},
           "path": {"pretrain_network_g": None},
           "val": {"key_metric": "psnr",
                   "metrics": {"psnr": {"type": "psnr", "crop_border": 0, "test_y_channel": False},
                               "ssim": {"type": "ssim", "crop_border": 0, "test_y_channel": False}}}}
    exp = tmp_path / "exp"
    os.makedirs(exp / "models")
    with open(exp / "unit.yml", "w") as f:
        f.write("# GENERATE TIME: now\n\n")
        yaml.safe_dump(opt, f)
    for label, seed in (("net_g_4", 1), ("net_g_ema_4", 2), ("net_g_ema_8", 3)):
        os.replace(_pth(tmp_path, seed), exp / "models" / f"{label}.pth")
    results, text = _captured(eval_run_ckpts.main, [str(exp), "--root", str(tmp_path),
                                                    "--work_dir", str(tmp_path / "work"),
                                                    "--device", "cpu"])
    assert list(results) == ["net_g_4", "net_g_ema_4", "net_g_ema_8"]
    assert "net_g_8: missing" in text and text.rstrip().endswith("DONE")
    best = max(results, key=lambda lb: results[lb]["psnr"])
    assert f"BEST by psnr: {best}" in text
    jopt = {**opt, "is_train": False, "dist": False,
            "path": {"pretrain_network_g": None, "models": str(tmp_path / "j"),
                     "training_states": str(tmp_path / "j"), "visualization": str(tmp_path / "j")}}
    jval = {**opt["datasets"]["val"], "phase": "val",
            "dataroot_gt": str(tmp_path / "val" / "gt"), "dataroot_lq": str(tmp_path / "val" / "input")}
    # The JAX runner's `get_root_logger` turns the `wavemamba_tpu` logger's
    # propagation off for the whole process: put it back after this test, so
    # that a later test's caplog still hears that logger.
    monkeypatch.setattr(logging.getLogger("wavemamba_tpu"), "propagate",
                        logging.getLogger("wavemamba_tpu").propagate)
    jmodel = jrunner.build_model(jopt)
    val_set = jdata.build_dataset(jval)
    for label, avg in results.items():
        jmodel.params = jload_network(str(exp / "models" / f"{label}.pth"))
        loader = jdata.ThreadedLoader(val_set, batch_size=1, num_workers=2)
        javg, _ = jmodel.validation(jdata.device_prefetch(loader), current_iter=label,
                                    num_shards=1, shard_id=0)
        assert avg["psnr"] == pytest.approx(javg["psnr"], abs=1e-3), label
        assert avg["ssim"] == pytest.approx(javg["ssim"], abs=1e-5), label


# ---------------------------------------------------------------- measurements

def test_conv1x1_sweep_runs_on_the_cpu_at_a_tiny_size():
    rows, text = _captured(conv1x1_sweep.main, [
        "--height", "32", "--width", "48", "--reps", "1", "--iters", "1", *ARCH_FLAGS,
        "--device", "cpu"])
    assert [r["conv1x1_as_conv"] for r in rows] == [list(v) for v in conv1x1_sweep.VARIANTS]
    assert all(r["finite"] and r["ms"] > 0 and r["k1_per_forward"] == 0 for r in rows)  # no card
    assert rows[0]["psnr_vs_default"] == 120.0
    assert all(r["psnr_vs_float32"] >= 40.0 for r in rows)
    lines = text.splitlines()
    assert lines[0].startswith("conv1x1_as_conv=()") and " median " in lines[0]
    assert json.loads(lines[4])["conv1x1_sweep"] == json.loads(json.dumps(rows))
    assert json.loads(lines[5].split(": ", 1)[1]) == {"K1": 0, "K7": 0}


def test_tiled_fidelity_runs_on_the_cpu_at_a_tiny_size(tmp_path):
    path = _pth(tmp_path)
    _write_pairs(str(tmp_path / "val"), n=2, shape=(24, 32))
    row, text = _captured(tiled_fidelity.main, [
        "--ckpt", path, "--val_dir", str(tmp_path / "val" / "input"), "--height", "64",
        "--width", "96", "--tile", "32", "--tile_batch", "2", *ARCH_FLAGS, "--device", "cpu"])
    assert row["frame"] == [64, 96] and row["finite"] and row["psnr"] > 20
    assert json.loads(text.splitlines()[-2])["tiled_fidelity"] == json.loads(json.dumps(row))


def test_chain_tune_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        chain_tune.main([])


# ---------------------------------------------------------------- imports

@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_script_imports_no_jax(name):
    """The module's own imports name neither jax, the JAX package, nor the
    JAX repo's scripts."""
    path = os.path.join(REPO, "wavemamba_torch", "scripts", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "wavemamba_tpu", "scripts")]


def test_every_new_script_runs_as_python_m_without_jax():
    """`python -m wavemamba_torch.scripts.<name> --help` for every new script
    in one interpreter where jax and the JAX package cannot be imported."""
    code = (
        "import runpy, sys\n"
        "sys.modules.update({'jax': None, 'jaxlib': None, 'wavemamba_tpu': None})\n"
        f"for name in {NEW_MODULES[:-1]!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_module('wavemamba_torch.scripts.' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), (name, e.code)\n"
        "    else:\n"
        "        raise AssertionError(name + ' --help did not exit')\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert run.returncode == 0 and run.stdout.rstrip().endswith("ok"), run.stderr[-2000:]
