"""The port's options, runner and yml pipelines (`wavemamba_torch/utils/
options.py`, `runner.py`, `pipelines/`) against wavemamba_tpu on the CPU.

Options parse to the same dict as the JAX package's (the port adds one key,
`device`). The runner's behaviour mirrors `tests/test_runner.py`. The
end-to-end test drives `train_pipeline` then `test_pipeline` on the CPU with
`scan_impl: pallas` (the kernels' plain versions here) and holds the losses
of its first steps against the JAX package's dataset, loader and runner (its
train pipeline's parts, without the device mesh), started from the same
weights and fed the same crops: 3e-4 relative, of which 5e-5 is the log
line's rounding (`%.4e`) and the rest three float32 AdamW updates apart.
"""

import glob
import logging
import os
import re
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from wavemamba_torch import convert, runner
from wavemamba_torch.checkpoint import find_resume_state, load_network
from wavemamba_torch.pipelines.test import test_pipeline as run_test_pipeline
from wavemamba_torch.pipelines.train import train_pipeline
from wavemamba_torch.runner import RestorationModel, build_model, train_config_from_opt
from wavemamba_torch.utils import options as toptions
from wavemamba_tpu import data as jdata
from wavemamba_tpu import runner as jrunner
from wavemamba_tpu.data.device_cache import DeviceCachedLoader as JaxDeviceCachedLoader
from wavemamba_tpu.models import build_network as jbuild_network
from wavemamba_tpu.models import init_for
from wavemamba_tpu.utils import misc as jmisc
from wavemamba_tpu.utils import options as joptions

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(glob.glob(os.path.join(REPO, "options", "*.yml")))
NET = {"type": "WaveMamba", "in_chn": 3, "wf": 8, "n_l_blocks": [1, 1, 1],
       "n_h_blocks": [1, 1, 1], "ffn_scale": 2.0, "scan_chunk": 16, "scan_impl": "pallas"}


@pytest.mark.parametrize("path", YMLS, ids=[os.path.basename(p) for p in YMLS])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_parse_options_matches(path, is_train, tmp_path):
    args = ["-opt", path, "--force_yml", "train:ema_decay=0.5", "logger:print_freq=7",
            "network_g:n_l_blocks=[1,1,2]", "path:pretrain_network_g=~/w.pth", "--debug"]
    want, _ = joptions.parse_options(str(tmp_path), is_train=is_train, args=args)
    got, parsed = toptions.parse_options(str(tmp_path), is_train=is_train, args=args)
    assert got.pop("device") == "cuda" and parsed.opt == path
    assert got == want
    assert got["name"].startswith("debug_") and got["network_g"]["n_l_blocks"] == [1, 1, 2]
    assert toptions.dict2str(got) == joptions.dict2str(want)
    assert toptions.yaml_load(path) == joptions.yaml_load(path)
    cpu, _ = toptions.parse_options(str(tmp_path), is_train, ["-opt", path, "--device", "cpu"])
    assert cpu["device"] == "cpu"
    forced, _ = toptions.parse_options(str(tmp_path), is_train,
                                       ["-opt", path, "--force_yml", "device=cpu"])
    assert forced["device"] == "cpu"


@pytest.mark.parametrize("value", ["~", "None", "true", "False", "[1, 2]", "12", "-3", "1e-4", "0.5",
                                   "cosine", "a-b"])
def test_force_yml_values_match(value):
    entry = [f"a:b={value}", f"c={value}"]
    want = joptions.apply_force_yml({"a": {"b": 0}}, entry)
    got = toptions.apply_force_yml({"a": {"b": 0}}, entry)
    assert got == want and type(got["c"]) is type(want["c"])


def test_copy_opt_file(tmp_path):
    src = tmp_path / "o.yml"
    src.write_text("name: x\n")
    (tmp_path / "exp").mkdir()
    toptions.copy_opt_file(str(src), str(tmp_path / "exp"))
    text = (tmp_path / "exp" / "o.yml").read_text()
    assert text.startswith("# GENERATE TIME: ") and "# CMD:" in text and text.endswith("name: x\n")


@pytest.mark.parametrize("path", YMLS, ids=[os.path.basename(p) for p in YMLS])
def test_train_config_from_opt_matches(path):
    opt = toptions.yaml_load(path)
    for loss_mode in ("l1fft", "uhd"):
        want = jrunner.train_config_from_opt(opt, loss_mode=loss_mode)
        got = train_config_from_opt(opt, loss_mode=loss_mode)
        for field in ("loss_mode", "lr", "weight_decay", "betas", "scheduler", "pixel_weight",
                      "fft_weight", "ema_decay", "grad_clip", "warmup_iter"):
            assert getattr(got, field) == getattr(want, field), field
    assert train_config_from_opt({}).fft_weight == 0.0 and train_config_from_opt({}).lr == 5e-4


def test_shipped_ymls_ask_for_the_float32_path_explicitly(tmp_path):
    """Every shipped yml builds as it is: the nine that ask for bf16 compute
    get it (no `--force_yml`), the float32 path is still one force away, and
    the xxl4 yml's bf16 network and train sections take a training step and
    serve a request on the CPU (the kernels' plain versions)."""
    from wavemamba_torch.models import config_from_opt

    dtypes = {}
    for path in YMLS:
        cfg = config_from_opt(toptions.yaml_load(path)["network_g"])
        dtypes[os.path.basename(path)] = cfg.compute_dtype
    assert sorted(dtypes.values()).count("bfloat16") == 9 and len(dtypes) == 11, dtypes
    opt = toptions.yaml_load(os.path.join(REPO, "options", "train_wavemamba_proc_bsrgan_xxl4.yml"))
    cfg = config_from_opt(opt["network_g"])
    assert (cfg.compute_dtype, cfg.scan_dtype, cfg.scan_impl) == ("bfloat16", "bfloat16", "pallas_fused")
    forced = toptions.yaml_load(os.path.join(REPO, "options", "train_wavemamba_proc_bsrgan_xxl4.yml"))
    toptions.apply_force_yml(forced, ["network_g:compute_dtype=float32", "network_g:scan_dtype=float32"])
    assert config_from_opt(forced["network_g"]).compute_dtype == "float32"
    uhdll = toptions.yaml_load(os.path.join(REPO, "options", "train_wavemamba_uhdll.yml"))
    assert config_from_opt(uhdll["network_g"]).wf == 32

    run = {**_opt(tmp_path, is_train=True), "network_g": opt["network_g"], "train": opt["train"]}
    model = build_model(run)
    assert all(p.dtype == torch.float32 for p in model.model.parameters())
    batch = next(_fake_loader(1, (16, 16)))
    losses = [float(model.optimize_parameters(batch)["total"]) for _ in range(2)]
    assert np.isfinite(losses).all() and model.state.step == 2
    out = model.test(batch["lq"])
    assert out.dtype == np.float32 and out.shape == batch["lq"].shape and np.isfinite(out).all()


def _opt(tmp_path, is_train=False, **net):
    return {
        "name": "unit", "model_type": "FeMaSRModel", "manual_seed": 0, "is_train": is_train,
        "device": "cpu", "network_g": {**NET, **net},
        "path": {"models": str(tmp_path / "models"), "training_states": str(tmp_path / "states"),
                 "visualization": str(tmp_path / "vis")},
        "train": {"optim_g": {"lr": 1e-3}, "total_iter": 10, "pixel_opt": {"loss_weight": 1.0}},
        "val": {"key_metric": "psnr",
                "metrics": {"psnr": {"type": "psnr", "crop_border": 0, "test_y_channel": False}}},
    }


def _fake_loader(n=2, shape=(24, 24), tensors=False):
    rs = np.random.RandomState(0)
    for i in range(n):
        gt = rs.rand(1, *shape, 3).astype(np.float32)
        lq = gt * 0.3
        if tensors:
            lq, gt = torch.from_numpy(lq), torch.from_numpy(gt)
        yield {"lq": lq, "gt": gt, "lq_path": [f"im{i}.png"], "gt_path": [f"im{i}.png"]}


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = _opt(tmp_path)
    del opt["device"]
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build_model(opt)
    assert build_model(_opt(tmp_path)).device.type == "cpu"


def test_validation_and_best_tracking(tmp_path):
    model = build_model(_opt(tmp_path))
    assert isinstance(model, RestorationModel) and not model.model.training
    avg, improved = model.validation(_fake_loader(), current_iter=1, save_img=True)
    assert "psnr" in avg and improved  # the first validation is always the best
    assert sorted(os.listdir(tmp_path / "vis")) == ["im0_1.png", "im1_1.png"]
    # The same data, as tensors (what `device_prefetch` hands out), cannot improve the best.
    avg2, improved2 = model.validation(_fake_loader(tensors=True), current_iter=2)
    assert avg2["psnr"] == pytest.approx(avg["psnr"], abs=1e-6)
    assert not improved2 and model.best_metric_results["psnr"] == avg["psnr"]


def test_runner_matches_jax_runner_from_the_same_weights(tmp_path, monkeypatch):
    """`test` on an odd size and `validation`, against the JAX runner loaded
    with the same weights: outputs within 1e-5, PSNR within 1e-3 dB."""
    opt = _opt(tmp_path, scan_impl="chunked")
    jopt = {**opt, "network_g": {k: v for k, v in opt["network_g"].items()}}
    # The JAX runner's `get_root_logger` turns the `wavemamba_tpu` logger's
    # propagation off for the whole process: put it back after this test, so
    # that a later test's caplog still hears that logger.
    monkeypatch.setattr(logging.getLogger("wavemamba_tpu"), "propagate",
                        logging.getLogger("wavemamba_tpu").propagate)
    jmodel = jrunner.build_model(jopt)
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    torch.save({"params": sd}, tmp_path / "w.pth")
    opt["path"]["pretrain_network_g"] = str(tmp_path / "w.pth")
    model = build_model(opt)
    x = np.random.RandomState(1).rand(1, 21, 37, 3).astype(np.float32)
    got, want = model.test(x), jmodel.test(x)
    assert got.shape == (1, 21, 37, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # 24x40 is what 21x37 pads to: the JAX side compiles one shape.
    avg, _ = model.validation(_fake_loader(3, (24, 40)), current_iter=1)
    javg, _ = jmodel.validation(_fake_loader(3, (24, 40)), current_iter=1, num_shards=1, shard_id=0)
    assert avg["psnr"] == pytest.approx(javg["psnr"], abs=1e-3)


def test_test_pads_odd_sizes_and_buckets(tmp_path):
    model = build_model(_opt(tmp_path))
    x = np.random.RandomState(1).rand(1, 21, 37, 3).astype(np.float32)
    out = model.test(x)
    assert out.shape == (1, 21, 37, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(model.test(torch.from_numpy(x)), out)
    # A pad wider than the image (numpy re-reflects; F.pad would raise).
    tiny = model.test(x[:, :3, :5])
    assert tiny.shape == (1, 3, 5, 3) and np.isfinite(tiny).all()
    opt = _opt(tmp_path)
    opt["val"]["bucket"] = True
    bucketed = build_model(opt)
    assert bucketed.test(x).shape == (1, 21, 37, 3)
    assert bucketed._bucket_ladder.buckets == [(128, 128)]
    tiled = model.test(x, tile={"tile_size": 16})  # tiled restoration runs (models/tiling.py)
    assert tiled.shape == (1, 21, 37, 3) and np.isfinite(tiled).all()


def test_save_checkpoint_paths_and_resume(tmp_path):
    opt = _opt(tmp_path, is_train=True)
    opt["train"]["ema_decay"] = 0.9
    model = build_model(opt)
    batch = next(_fake_loader(1, (16, 16)))
    for _ in range(2):
        metrics = model.optimize_parameters(batch)
    assert set(metrics) == {"l1", "total"} and model.state.step == 2
    assert model.current_lr() == model.current_lr(5) == 1e-3
    assert model.current_params() is model.state.ema
    assert set(model.current_params(use_ema=False)) == set(model.state.ema)
    model.save(7)
    model.save_best()
    names = sorted(os.listdir(tmp_path / "models"))
    assert names == ["net_g_7.pth", "net_g_best_latest.pth", "net_g_ema_7.pth",
                     "net_g_ema_latest.pth", "net_g_latest.pth"]
    assert find_resume_state(str(tmp_path / "states")).endswith("7.state")
    ema = load_network(str(tmp_path / "models" / "net_g_ema_7.pth"), device="cpu")
    assert all(torch.equal(ema[k], v) for k, v in model.state.ema.items())
    # The EMA weights are what `test` runs, and they differ from the trained ones.
    x = batch["lq"]
    with_ema = model.test(x)
    model.state.ema = None
    assert np.abs(model.test(x) - with_ema).max() > 0
    opt2 = _opt(tmp_path, is_train=True)
    opt2["train"]["ema_decay"] = 0.9
    opt2["manual_seed"] = 5
    fresh = build_model(opt2)
    assert fresh.resume() == 2 and fresh.state.step == 2
    np.testing.assert_array_equal(fresh.test(x), with_ema)
    empty = _opt(tmp_path / "none", is_train=True)
    assert build_model(empty).resume() == 0


def test_validation_sharding_covers_disjoint_halves(tmp_path, monkeypatch):
    model = build_model(_opt(tmp_path))
    full, _ = model.validation(_fake_loader(4), current_iter=1)
    s0, _ = model.validation(_fake_loader(4), current_iter=1, num_shards=2, shard_id=0)
    s1, _ = model.validation(_fake_loader(4), current_iter=1, num_shards=2, shard_id=1)
    assert full["psnr"] == pytest.approx((s0["psnr"] + s1["psnr"]) / 2, abs=1e-9)
    assert s0["psnr"] != pytest.approx(s1["psnr"], abs=1e-12)
    # Across processes each metric's (sum, count) is summed over the group
    # (`parallel.mesh.world_sum`): as rank 1 of a patched 2-rank world, whose
    # sum adds rank 0's pairs (images 0 and 2), the average is the whole set's.
    monkeypatch.setattr(runner, "_world", lambda: (2, 1))
    reduced = []

    def two_rank_sum(local):
        reduced.append(np.array(local))
        return np.array(local, np.float64) + [[2 * s0["psnr"], 2.0]]

    monkeypatch.setattr(runner, "world_sum", two_rank_sum)
    both, _ = model.validation(_fake_loader(4), current_iter=1)
    assert len(reduced) == 1 and reduced[0][0, 1] == 2.0
    assert reduced[0][0, 0] == pytest.approx(2 * s1["psnr"], abs=1e-9)
    assert both["psnr"] == pytest.approx(full["psnr"], abs=1e-9)


def test_uhd_model_rejects_single_output_net(tmp_path):
    opt = _opt(tmp_path, is_train=True)
    opt["model_type"] = "UHDModel"
    model = build_model(opt)
    assert model.tcfg.loss_mode == "uhd"
    rs = np.random.RandomState(0)
    batch = {"lq": rs.rand(1, 16, 16, 3).astype(np.float32),
             "gt": rs.rand(1, 16, 16, 3).astype(np.float32)}
    with pytest.raises(TypeError, match="two outputs"):
        model.optimize_parameters(batch)
    with pytest.raises(KeyError, match="Unknown model_type"):
        build_model({**_opt(tmp_path), "model_type": "SRGANModel"})
    # ART builds (the second family) and, with one output, is no UHDModel either
    art = {**opt, "network_g": {"type": "ART", "dim": 8, "num_heads": 2, "n_blocks": 1}}
    art_model = build_model(art)
    assert type(art_model.model).__name__ == "ART" and art_model.tcfg.loss_mode == "uhd"
    with pytest.raises(TypeError, match="two outputs"):
        art_model.optimize_parameters(batch)


def test_key_metric_build_failure_is_fatal_and_aux_warns(tmp_path):
    opt = _opt(tmp_path)
    opt["val"]["metrics"]["lpips"] = {"type": "lpips"}  # no weights_path: the build fails
    model = build_model(opt)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    model.logger.addHandler(handler)
    try:
        avg, _ = model.validation(_fake_loader(), current_iter=1)
    finally:
        model.logger.removeHandler(handler)
    assert "psnr" in avg and "lpips" not in avg
    assert any("metric lpips skipped" in r and "weights_path" in r for r in records)
    opt["val"]["key_metric"] = "lpips"
    with pytest.raises(ValueError, match="key metric 'lpips'"):
        build_model(opt).validation(_fake_loader(), current_iter=1)


# ---------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    for split, n in (("train", 6), ("val", 2)):
        for sub in ("gt", "input"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            gt = (rs.rand(40, 48, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / split / "gt" / f"{i:03d}.png"), gt)
            cv2.imwrite(str(root / split / "input" / f"{i:03d}.png"), (gt * 0.3).astype(np.uint8))
    return root


def _e2e_opt(data_root, batch, total_iter, val=True, cache_on_device=False, **extra):
    opt = {
        "name": "tiny_e2e", "model_type": "FeMaSRModel", "scale": 1, "manual_seed": 0,
        "datasets": {"train": {
            "name": "t", "type": "PairedImageDataset",
            "dataroot_gt": str(data_root / "train" / "gt"),
            "dataroot_lq": str(data_root / "train" / "input"),
            "io_backend": {"type": "disk"}, "gt_size": 32, "geometric_augs": True,
            "use_native": False, "batch_size_per_gpu": batch,
            "num_worker_per_gpu": 1,  # one worker: the crops are drawn in order
            "dataset_enlarge_ratio": 8, "cache_on_device": cache_on_device}},
        "network_g": dict(NET),
        "path": {"pretrain_network_g": None, "resume_state": None},
        "train": {"optim_g": {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-3, "betas": [0.9, 0.99]},
                  "scheduler": {"type": "CosineAnnealingRestartCyclicLR", "periods": [10, 100],
                                "restart_weights": [1, 1], "eta_mins": [1e-3, 1e-7]},
                  "total_iter": total_iter, "ema_decay": 0.9,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                  "fft_opt": {"type": "FFTLoss", "loss_weight": 0.1}},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 3, "use_tb_logger": False},
        **extra,
    }
    if val:
        opt["datasets"]["val"] = {"name": "v", "type": "PairedImageDataset",
                                  "dataroot_gt": str(data_root / "val" / "gt"),
                                  "dataroot_lq": str(data_root / "val" / "input"),
                                  "io_backend": {"type": "disk"}}
        opt["val"] = {"val_freq": 3, "save_img": True, "key_metric": "psnr", "metrics": {
            "psnr": {"type": "psnr", "crop_border": 0, "test_y_channel": False},
            "ssim": {"type": "ssim", "crop_border": 0, "test_y_channel": False}}}
    return opt


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(logger_name, fn):
    """Run `fn` and return (its result, the lines the package's logger got)."""
    logger = logging.getLogger(logger_name)
    handler = _Lines()
    logger.addHandler(handler)
    try:
        return fn(), handler.lines
    finally:
        logger.removeHandler(handler)


def _totals(lines):
    return [float(m.group(1)) for ln in lines if (m := re.search(r"total: (\S+)", ln))]


def _train_against_jax(synth_data, tmp_path, cache_on_device, monkeypatch):
    """Six steps of the port's train pipeline from JAX's initial weights, the
    first three held against the JAX package's (rtol 3e-4). The JAX side is
    its dataset, sampler, loader and runner as its train pipeline wires them,
    seeded alike, for three steps; without the pipeline's 8-device mesh,
    whose SPMD compile alone takes minutes here. With `cache_on_device` both
    sides draw from their device-resident loaders (the same batches, bit for
    bit: tests/test_torch_device_cache.py), else from their host loaders.
    Returns the port's model, its log lines, its options and its arguments."""
    jopt = _e2e_opt(synth_data, 8, 3, val=False)
    jopt["is_train"] = True
    jmisc.set_random_seed(jopt["manual_seed"])
    jtrain = jopt["datasets"]["train"]
    jset = jdata.build_dataset({**jtrain, "phase": "train", "scale": 1})
    sampler = jdata.EnlargedSampler(len(jset), 1, 0, 8)
    if cache_on_device:
        jloader = JaxDeviceCachedLoader(jset, batch_size=8, seed=0, sampler=sampler)
    else:
        jloader = jdata.ThreadedLoader(jset, batch_size=8, num_workers=1, drop_last=True, seed=0,
                                       sampler=sampler)
    jloader.set_epoch(0)
    # The JAX runner's `get_root_logger` turns the `wavemamba_tpu` logger's
    # propagation off for the whole process: put it back after this test, so
    # that a later test's caplog still hears that logger.
    monkeypatch.setattr(logging.getLogger("wavemamba_tpu"), "propagate",
                        logging.getLogger("wavemamba_tpu").propagate)
    jmodel = jrunner.build_model(jopt)
    want = [float(jmodel.optimize_parameters(batch)["total"])
            for _, batch in zip(range(3), jloader)]
    assert len(want) == 3 and int(jmodel.state["step"]) == 3

    # The same initial weights, converted, as the port's pretrained network.
    cfg = jbuild_network(dict(NET))
    params = init_for(cfg)(jax.random.PRNGKey(0), cfg)
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    torch.save({"params": sd}, tmp_path / "init.pth")

    opt = _e2e_opt(synth_data, 8, 6, cache_on_device=cache_on_device)
    opt["path"]["pretrain_network_g"] = str(tmp_path / "init.pth")
    opt_path = tmp_path / "opt.yml"
    opt_path.write_text(yaml.safe_dump(opt))
    args = ["-opt", str(opt_path), "--device", "cpu"]
    model, lines = _logged("wavemamba_torch", lambda: train_pipeline(str(tmp_path), args=args))
    got = _totals(lines)
    assert len(got) == 6
    np.testing.assert_allclose(got[:3], want, rtol=3e-4)
    assert all(m.scan_impl == "pallas" for m in model.model.modules() if hasattr(m, "scan_impl"))
    assert not any("cache_on_device unavailable" in ln for ln in lines)
    staged = any("cache_on_device: dataset staged on cpu" in ln for ln in lines)
    assert staged == cache_on_device
    return model, lines, opt, opt_path, args


def test_train_pipeline_from_the_device_cache_matches_jax(synth_data, tmp_path, monkeypatch):
    """`cache_on_device: true` on both sides: the port's device-resident
    loader (on the CPU here) against JAX's `DeviceCachedLoader`."""
    _train_against_jax(synth_data, tmp_path, cache_on_device=True, monkeypatch=monkeypatch)


def test_train_then_test_pipeline_end_to_end(synth_data, tmp_path, monkeypatch):
    # The host loaders on both sides (`ThreadedLoader` + `device_prefetch`),
    # as the shipped ymls without `cache_on_device` train; then the saved
    # outputs, a resume and the test pipeline.
    model, lines, opt, opt_path, args = _train_against_jax(synth_data, tmp_path,
                                                           cache_on_device=False,
                                                           monkeypatch=monkeypatch)

    exp = tmp_path / "experiments" / "tiny_e2e"
    assert {"net_g_3.pth", "net_g_6.pth", "net_g_latest.pth", "net_g_ema_6.pth",
            "net_g_best_latest.pth"} <= set(os.listdir(exp / "models"))
    assert sorted(os.listdir(exp / "training_states")) == ["-1.state", "3.state", "6.state"]
    assert len(os.listdir(exp / "visualization")) == 4  # 2 images at iters 3 and 6
    assert "psnr" in model.best_metric_results and (exp / "opt.yml").exists()
    assert model.state.step == 6

    # --auto_resume continues in place, past the saved iteration.
    opt["train"]["total_iter"] = 8
    opt_path.write_text(yaml.safe_dump(opt))
    model2 = train_pipeline(str(tmp_path), args=args + ["--auto_resume"])
    assert not [d for d in (tmp_path / "experiments").iterdir() if "archived" in d.name]
    assert model2.state.step == 8 and (exp / "training_states" / "-1.state").exists()

    # The test pipeline on the trained weights: metrics and images.
    test_opt = {"name": "tiny_e2e_test", "model_type": "FeMaSRModel", "scale": 1,
                "datasets": {"test_1": {**opt["datasets"]["val"], "name": "valset"}},
                "network_g": dict(NET),
                "path": {"pretrain_network_g": str(exp / "models" / "net_g_latest.pth")},
                "val": opt["val"]}
    test_path = tmp_path / "test.yml"
    test_path.write_text(yaml.safe_dump(test_opt))
    results = run_test_pipeline(str(tmp_path), args=["-opt", str(test_path), "--device", "cpu"])
    assert set(results) == {"valset"} and set(results["valset"]) == {"psnr", "ssim"}
    assert np.isfinite(list(results["valset"].values())).all()
    vis = tmp_path / "results" / "tiny_e2e_test" / "visualization"
    assert sorted(os.listdir(vis)) == ["000_tiny_e2e_test.png", "001_tiny_e2e_test.png"]
    assert cv2.imread(str(vis / "000_tiny_e2e_test.png")).shape == (40, 48, 3)


def test_pipelines_run_as_modules_and_need_a_card_by_default(synth_data, tmp_path):
    """`python -m wavemamba_torch.pipelines.train -opt <yml>`: on the CPU with
    `--device cpu`; without it, where CUDA is missing, it raises."""
    opt_path = tmp_path / "opt.yml"
    opt_path.write_text(yaml.safe_dump(_e2e_opt(synth_data, 2, 1, val=False)))
    cmd = [sys.executable, "-m", "wavemamba_torch.pipelines.train", "-opt", str(opt_path)]
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    ok = subprocess.run(cmd + ["--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                        text=True, timeout=600)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert (tmp_path / "experiments" / "tiny_e2e" / "models" / "net_g_latest.pth").exists()
    refused = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert refused.returncode != 0 and "pass device='cpu'" in refused.stderr


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of `wavemamba_torch` (and `chip_smoke.py`'s own
    imports) leaves `jax` and `wavemamba_tpu` out of `sys.modules`."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wavemamba_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(wavemamba_torch.__path__, 'wavemamba_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'wavemamba_tpu')]\n"
        "assert not bad, bad\n"
        "data_layer = ['utils.matlab', 'utils.img_process_util', 'data.degradations', 'data.native',\n"
        "              'scripts.make_proc_dataset', 'utils.lmdb_util', 'utils.flow_util',\n"
        "              'ops.diffjpeg', 'ops.arch_util']\n"
        "assert not [m for m in data_layer if 'wavemamba_torch.' + m not in names], names\n"
        "assert len(names) >= 55, names\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|wavemamba_tpu)\b", src, re.M)
