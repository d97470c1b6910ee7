"""What `chip_smoke.py` reports without a card: the `kernels` line's top-level
errors of K1 and K2 are the float32 rows' own, the bf16 rows' in `bf16`; the
yml training phases' options are the shipped ymls' sections; the build log's
and the profile's readings."""

import importlib.util
import json
import os
import pathlib

import pytest
import torch

from wavemamba_torch.models import config_from_opt
from wavemamba_torch.utils.options import yaml_load

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def test_kernel_errors_take_the_float32_rows_at_the_top():
    k1 = [{"max_abs_err": 1.1e-5}, {"max_abs_err": 2e-6}]
    k1_bf16 = [{"max_abs_err": 0.25}]
    k2 = [{"k1": {"y": 3e-6, "carries": 4e-6}, "max_abs_err": {"dx": 1e-6, "dA": 5e-6},
           "max_rel_err": {"dx": 1.3e-6, "dA": 2e-7}}]
    k2_bf16 = [{"k1": {"y": 0.5}, "max_abs_err": {"dx": 1.0, "dA": 7e-6},
                "max_rel_err": {"dx": 3e-3, "dA": 1.8e-6}}]
    errs = chip_smoke.kernel_errors(k1, k1_bf16, k2, k2_bf16)
    assert errs["K1"] == {"max_abs_err": 1.1e-5, "bf16_max_abs_err": 0.5}
    assert errs["K2"] == {"max_abs_err": 5e-6, "max_rel_err": 1.3e-6,
                          "bf16_max_abs_err": 1.0, "bf16_max_rel_err": 3e-3}


def test_bf16_chain_errors_allow_one_step():
    """A bf16 output one bf16 step from the plain chain's passes; an element
    a step plus more than the loose bound (1e-2 of the max, 0.02) off fails."""
    want = torch.tensor([1.0, 0.5, -2.0, 0.25]).bfloat16()
    one = torch.tensor([1.0078125, 0.5, -2.0, 0.25]).bfloat16()
    err = chip_smoke.chain_errors_bf16(one, want)
    assert err["loose_excess"] <= 0 and err["share_differing"] == 0.25
    far = torch.tensor([1.0, 0.5, -2.0, 0.28]).bfloat16()
    assert chip_smoke.chain_errors_bf16(far, want)["loose_excess"] > 0


@pytest.mark.parametrize("phase", ["train_fast", "train_mixed"])
def test_yml_train_phases_take_the_ymls_sections(phase):
    """The card run holds no PyYAML: its options dicts repeat the shipped
    ymls' `network_g` and `train` sections as they are (block recompute on,
    'save_scan', as the ymls leave it) and their `datasets.train` settings
    (`cache_on_device` among them); only the data is made there."""
    yml, make_opt, seed, streams, _ = chip_smoke.TRAIN_YMLS[phase]
    opt, want = make_opt(seed), yaml_load(str(REPO / yml))
    assert opt["network_g"] == want["network_g"]
    assert opt["train"] == want["train"]
    cfg = config_from_opt(opt["network_g"])
    assert streams == (f"torch.{cfg.compute_dtype}", f"torch.{cfg.scan_dtype}")
    assert (cfg.remat, cfg.remat_policy) == (True, "save_scan")
    got, want_set = opt["datasets"]["train"], want["datasets"]["train"]
    for key, value in want_set.items():
        if key not in ("name", "dataroot_gt", "dataroot_lq"):
            assert got[key] == value, key
    assert got.get("cache_on_device", False) == want_set.get("cache_on_device", False)


@pytest.mark.parametrize("mode", range(8))
def test_np_dihedral_is_the_host_augmentation(mode):
    """`device_cache`'s numpy transcription of the dihedral modes is the JAX
    package's host `data_augmentation`, mode for mode."""
    import numpy as np

    from wavemamba_tpu.data.transforms import data_augmentation

    img = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(4, 4, 3)
    np.testing.assert_array_equal(chip_smoke.np_dihedral(img, mode), data_augmentation(img, mode))


def test_template_tags_name_each_instantiation():
    assert chip_smoke.template_tags("Lb1E13__nv_bfloat16S1_EEvPKT2_") == ["replay", "bf16", "bf16"]
    assert chip_smoke.template_tags("Lb0E13__nv_bfloat16fEEvPKT2_") == ["pass1", "bf16", "f32"]
    assert chip_smoke.template_tags("ffEEvPKT1_") == ["f32", "f32"]
    assert chip_smoke.template_tags("EEvPKfS1_") == []


def test_profiled_launches_flag_a_short_profile():
    """K1's and K3's calls each run one replay kernel; a profile that recorded
    fewer of them than the wrappers launched is flagged."""
    rows = [(9.0, 27, "void (anonymous namespace)::chunk_scan<16, 2, true, float, float>(...)"),
            (8.0, 28, "void (anonymous namespace)::chunk_scan<16, 2, false, float, float>(...)"),
            (1.0, 14, "void (anonymous namespace)::selective_chunk<16, true>(...)")]
    got = chip_smoke.profiled_launches(rows, {"k1": 28, "k3": 14})
    assert got["profiled_launches"] == {"k1": 27, "k3": 14} and got["short_profile"]
    whole = chip_smoke.profiled_launches(rows, {"k1": 27, "k3": 14})
    assert not whole["short_profile"]


def test_the_data_phase_trains_the_uhdll_yml_as_written(tmp_path):
    """The data phase's options repeat the uhdll yml's `network_g` and `train`
    sections and its `datasets.train` settings as they are (no
    `transfer_dtype`: the native crop; block recompute on, 'save_scan');
    only the dataroots point at the generated set."""
    opt = chip_smoke.data_train_opt(73, str(tmp_path))
    want = yaml_load(str(REPO / "options" / "train_wavemamba_uhdll.yml"))
    assert opt["network_g"] == want["network_g"] and opt["train"] == want["train"]
    got_set, want_set = opt["datasets"]["train"], want["datasets"]["train"]
    for key in ("dataroot_gt", "dataroot_lq"):
        assert got_set.pop(key) == str(tmp_path / "train" / want_set.pop(key).split("/")[-1])
    assert {k: v for k, v in got_set.items() if k not in ("phase", "scale")} == want_set
    cfg = config_from_opt(opt["network_g"])
    assert (cfg.remat, cfg.remat_policy) == (True, "save_scan")
    assert chip_smoke.PROC_ARGS[chip_smoke.PROC_ARGS.index("--seed") + 1] == "2"


def test_deploy_phase_is_on_the_main_path():
    """`main` starts the exports right after the builds, runs the deploy
    phase before the profile, stops the children at exit, and adds the
    deploy route's K1 launches to the `kernels` line."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert (src.index("phase_device()") < src.index("start_children(export_cmds()")
            < src.index("phase_k1()"))
    assert "atexit.register(stop_children, exports)" in src
    assert src.index("phase_data()") < src.index("phase_deploy(") < src.index("phase_profile(")
    assert '+ deploy["k1_launches"]' in src
    assert '+ deploy["k3_launches"]' in src and '+ deploy["k7_launches"]' in src
    assert '+ deploy["k6_launches"]' in src
    for flags in chip_smoke.DEPLOY_EXPORTS.values():
        assert "--allow_custom_calls" in flags and "--target" in flags
        assert flags[flags.index("--shapes") + 1] == "x".join(map(str, chip_smoke.DEPLOY_BUCKET))


def _deploy_row():
    return {"requests": [{"image": [1080, 1920], "max_abs_vs_eager": 0.0, "k1_in_graph": 28},
                         {"image": [720, 1280], "max_abs_vs_eager": 2e-6, "k1_in_graph": 28}],
            "same_bits_twice": True, "pipelined_matches": True,
            "tiled": {"max_abs_vs_eager_tiled": 0.0},
            "fast_u8": {"psnr_vs_float32_db": 51.8, "k1_in_graph": 28},
            "compile_cache": {"cold_built_k1": True, "warm_built": False},
            "mesh_tiles": {"tile_batches": 18, "ranks_same_bits": True, "ranks": [
                {"max_abs_vs_one_process": 4e-7, "fault_max_abs_vs_one_process": 0.3,
                 "k1_in_graph": 28, "replays": 18} for _ in range(2)]}}


@pytest.mark.parametrize("fault", [
    ("requests", 1, "max_abs_vs_eager", 2e-5), ("requests", 0, "k1_in_graph", 0),
    ("same_bits_twice", None, None, False), ("pipelined_matches", None, None, False),
    ("tiled", None, "max_abs_vs_eager_tiled", 1e-3), ("fast_u8", None, "psnr_vs_float32_db", 39.9),
    ("fast_u8", None, "k1_in_graph", 27), ("compile_cache", None, "warm_built", True),
    ("compile_cache", None, "cold_built_k1", False),
    ("mesh_tiles", 1, "max_abs_vs_one_process", 2e-6),
    ("mesh_tiles", 0, "fault_max_abs_vs_one_process", 5e-5),
    ("mesh_tiles", 1, "replays", 17), ("mesh_tiles", 0, "k1_in_graph", 0),
    ("mesh_tiles", None, "ranks_same_bits", False)])
def test_deploy_readings_fail_loudly(fault):
    """A deploy reading out of its contract raises (the script then exits
    non-zero without its last line); the good readings pass. The sharded
    tile program's (`mesh_tiles`): each rank within 1e-6 of the one-process
    tiles, the planted swap beyond 100 times that, K1 in every tile batch,
    the ranks' same bits."""
    chip_smoke.check_deploy(_deploy_row())
    row = _deploy_row()
    key, index, field, value = fault
    if field is None:
        row[key] = value
    elif index is None:
        row[key][field] = value
    elif key == "mesh_tiles":
        row[key]["ranks"][index][field] = value
    else:
        row[key][index][field] = value
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.check_deploy(row)


def test_op_artifacts_are_exported_beside_the_cli():
    """The two artifacts that keep the chain op and K3's op are made by
    `export_child` (`deploy.export_model`: the CLI has no conv_impl flag),
    started with the CLI's children and with their environment (no card):
    `fast(conv_impl="fused")` with uint8 I/O, and `scan_impl: pallas` in
    float32; the deploy phase takes the eager fused fast model."""
    import inspect
    import sys

    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    cmds = chip_smoke.export_cmds()
    assert set(cmds) == set(chip_smoke.DEPLOY_EXPORTS) | {"fused_fast_u8", "k3"}
    for name in chip_smoke.DEPLOY_OP_EXPORTS:
        assert cmds[name] == [sys.executable, "-c",
                              "import sys, chip_smoke; chip_smoke.export_child(*sys.argv[1:])", name]
    assert chip_smoke.deploy_op_config("fused_fast_u8") == WaveMambaConfig.fast(conv_impl="fused")
    assert chip_smoke.deploy_op_config("k3") == WaveMambaConfig(scan_impl="pallas")
    assert chip_smoke.DEPLOY_OP_EXPORTS == {"fused_fast_u8": "uint8", "k3": "float32"}
    src = inspect.getsource(chip_smoke.export_child)
    assert "allow_custom_calls=True" in src and "[DEPLOY_BUCKET]" in src
    assert "phase_deploy(exports, model, fast_model, fast_fused_model)" in inspect.getsource(
        chip_smoke.main)


def _ops_row():
    def row(name, **kw):
        want = chip_smoke.DEPLOY_OP_KERNELS[name]
        named = chip_smoke.deploy_op_named(name)
        return {"platforms": ["cuda"], "in_graph": dict(want), "eager_counts": dict(want),
                "wrapper_counts_main_path": {k: 2 * n for k, n in want.items()},
                "profile": {"replay": {"launches_profiled": dict(named)},
                            "eager": {"launches_profiled": dict(named)}},
                "same_bits_again": True, **kw}

    return {"fused_fast_u8": row("fused_fast_u8", max_abs_levels_vs_eager=1,
                                 psnr_vs_float32_db=52.0),
            "k3": row("k3", max_abs_vs_eager=3e-6)}


@pytest.mark.parametrize("fault", [
    ("fused_fast_u8", "max_abs_levels_vs_eager", 2), ("fused_fast_u8", "psnr_vs_float32_db", 39.0),
    ("k3", "max_abs_vs_eager", 2e-5), ("k3", "same_bits_again", False),
    ("fused_fast_u8", "platforms", ["cpu", "cuda"]),
    ("fused_fast_u8", ("in_graph", "K7"), 75), ("k3", ("in_graph", "K3"), 13),
    ("fused_fast_u8", ("eager_counts", "K1"), 27), ("k3", ("wrapper_counts_main_path", "K3"), 14),
    ("fused_fast_u8", ("profile", "replay", "launches_profiled", "chain"), 0),
    ("fused_fast_u8", ("profile", "eager", "launches_profiled", "K3"), 14),
    ("k3", ("profile", "eager", "launches_profiled", "K3"), 15)])
def test_deploy_op_readings_fail_loudly(fault):
    """A reading of the op artifacts out of its contract raises: the fused
    fast bytes within one level of the eager ones and >= 40 dB from float32,
    K3's graph within 1e-5; in each graph the eager forward's kernels (K1 28
    and K7 76; K3 14), twice in the wrappers' count over the warm-up and the
    capture; by kernel name in a profiled replay and eager forward each
    kernel of the graph and no other, no more than the graph holds (a
    profile that dropped records passes, flagged); the same bits twice; a
    card-only artifact. Good readings pass."""
    chip_smoke.check_deploy_ops(_ops_row())
    short = _ops_row()
    short["fused_fast_u8"]["profile"]["replay"]["launches_profiled"].update(K1=27, chain=73)
    short["k3"]["profile"]["eager"]["launches_profiled"]["K3"] = 13
    chip_smoke.check_deploy_ops(short)
    row = _ops_row()
    name, field, value = fault
    target = row[name]
    if isinstance(field, tuple):
        for key in field[:-1]:
            target = target[key]
        field = field[-1]
    target[field] = value
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.check_deploy_ops(row)


def test_named_launches_count_each_kernel_by_name():
    """K1's and K3's replay kernels and the chain kernel, by name."""
    rows = [(5.0, 28, "void chunk_scan<float, float, true, 64>(Params)"),
            (1.0, 28, "void chunk_scan<float, float, false, 64>(Params)"),
            (2.0, 14, "void selective_chunk<16, true>(P)"), (1.0, 14, "void selective_chunk<16, false>(P)"),
            (3.0, 76, "void (anonymous namespace)::chain_kernel<__nv_bfloat16>(Chain, Plan)"),
            (9.0, 3, "cudnn::conv")]
    assert chip_smoke.named_launches(rows) == {"K1": 28, "K3": 14, "chain": 76}


def test_a_failed_export_raises(tmp_path):
    """An export child that fails stops the run with its log's end."""
    import sys

    jobs = chip_smoke.start_children(
        {"x": [sys.executable, "-c", "print('Traceback: the trace failed'); raise SystemExit(3)"]},
        str(tmp_path), env=chip_smoke.EXPORT_ENV)
    with pytest.raises(RuntimeError, match="exited 3.*the trace failed"):
        chip_smoke.phase_deploy(jobs, None, None)
    assert chip_smoke.first_request_s("artifact: shapes [(1152, 1920)]\na.png: 2.097s\n") == 2.097


def test_the_script_exits_nonzero_when_a_phase_fails(tmp_path):
    """A failed check in the deploy phase escapes `main` (nothing catches
    it): the process exits non-zero and prints no `ok` line. The card is
    stubbed, and the first phase runs a deploy phase that fails."""
    import subprocess
    import sys

    script = tmp_path / "drive.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import torch
import chip_smoke as cs
torch.cuda.is_available = lambda: True
def failing_deploy(*a, **k):
    cs.check(False, "the deploy phase's readings")
# Without a card nothing before the deploy phase can run: the first phase
# calls it, as main calls it after the others.
cs.phase_device = lambda: cs.phase_deploy({{}}, None, None)
cs.phase_deploy = failing_deploy
cs.main()
""")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "check failed: the deploy phase's readings" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_art_and_secondary_phases_are_on_the_main_path():
    """`main` runs ART after the data phase (whose generated set it trains
    from) and the secondary pieces before the deploy phase, and adds the
    profiler's traced forward to K1's launches; the deploy phase serves the
    sharded tile program and adds its ranks' K1."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert (src.index("phase_data()") < src.index("phase_art(") < src.index("phase_secondary(")
            < src.index("phase_deploy(") < src.index("phase_profile("))
    assert '+ secondary["k1_launches"]' in src
    assert "deploy_mesh(tiled)" in inspect.getsource(chip_smoke.phase_deploy)
    assert chip_smoke.DEPLOY_EXPORTS["xxl4_mesh2"][-2:] == ["--mesh_devices", "2"]


def test_art_phase_trains_the_uhdll_yml_with_art(tmp_path, monkeypatch):
    """The ART phase's yml is the uhdll yml with `network_g: {type: ART}`
    (ARTConfig's defaults), the generated set, ART_ITERS iterations, each
    logged, one loader thread (the crops' draws in a fixed order); every
    other section as the yml has it."""
    monkeypatch.setattr(chip_smoke, "ART_DIR", str(tmp_path))
    path = chip_smoke.art_yml("art_x", str(tmp_path / "proc"))
    got = yaml_load(path)
    want = yaml_load(str(REPO / "options" / "train_wavemamba_uhdll.yml"))
    from wavemamba_torch.models import ARTConfig

    assert config_from_opt(got["network_g"]) == ARTConfig()
    assert got["train"]["total_iter"] == chip_smoke.ART_ITERS and got["name"] == "art_x"
    assert got["logger"]["print_freq"] == 1
    assert got["datasets"]["train"]["dataroot_gt"] == str(tmp_path / "proc" / "train" / "gt")
    for key in ("optim_g", "scheduler", "pixel_opt", "fft_opt"):
        assert dict(got["train"][key]) == dict(want["train"][key])
    assert got["datasets"]["train"]["batch_size_per_gpu"] == 8
    assert got["datasets"]["train"]["num_worker_per_gpu"] == 1  # the batches repeat
    assert got["datasets"]["train"]["gt_size"] == 512
    assert json.loads(json.dumps(got["val"])) == json.loads(json.dumps(want["val"]))


def test_parallel_phase_is_on_the_main_path():
    """`main` runs the parallel phase after the data phase (whose generated
    set it trains from) and before the profile, and adds its children's K1
    and K2 launches to the `kernels` line."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_data()") < src.index("phase_parallel(") < src.index("phase_profile(")
    assert '+ par["k1_launches"]' in src and '+ par["k2_launches"]' in src
    assert '"launches_parallel": par["k1_launches"]' in src
    assert '"launches_parallel": par["k2_launches"]' in src
    # (f): the gloo ranks train through the sequence-sharded scan, and with
    # the planted fault; this process takes the 'chunked' steps meanwhile
    child = inspect.getsource(chip_smoke.parallel_gloo_child)
    assert "seq_train(device, mesh)" in child and "seq_train(device, mesh, fault=True)" in child
    phase = inspect.getsource(chip_smoke.phase_parallel)
    assert phase.index('seq_train(torch.device("cuda"))') < phase.index("wait_children(procs)")
    assert (chip_smoke.SEQ_TRAIN_BATCH, chip_smoke.SEQ_TRAIN_SIZE, chip_smoke.SEQ_TRAIN_STEPS) == (
        2, 256, 2)


def test_a_failed_child_stops_the_others_and_fails_the_script(tmp_path):
    """A child of the parallel phase that exits non-zero stops the children
    still running (a rank left alone would wait in a collective) and fails
    the check with its output's end; run from `main`, the process exits
    non-zero and prints no `ok` line."""
    import subprocess
    import sys
    import time

    cmds = {"waiting_rank": [sys.executable, "-c", "import time; time.sleep(120)"],
            "failing_rank": [sys.executable, "-c", "print('rank 1 lost its peer'); raise SystemExit(3)"]}
    t0 = time.perf_counter()
    procs = chip_smoke.start_children(cmds, str(tmp_path))
    with pytest.raises(RuntimeError, match="child failing_rank exited 3: rank 1 lost its peer"):
        chip_smoke.wait_children(procs, timeout=60)
    assert time.perf_counter() - t0 < 60
    assert all(proc.poll() is not None for _, _, proc in procs.values())
    ok = chip_smoke.run_children({"a": [sys.executable, "-c", "print('fine')"]}, str(tmp_path))
    assert ok["a"][1] == "fine\n"
    script = tmp_path / "drive.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import torch
import chip_smoke as cs
torch.cuda.is_available = lambda: True
# Without a card nothing before the parallel phase can run: the first phase
# starts a child that fails, as the parallel phase's ranks would.
cs.phase_device = lambda: cs.run_children(
    {{"gloo_rank1": [sys.executable, "-c", "raise SystemExit(5)"]}}, {str(tmp_path)!r})
cs.main()
""")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "check failed: child gloo_rank1 exited 5" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_scripts_phase_is_on_the_main_path():
    """`main` runs the scripts phase after the data phase (whose generated
    sets the scripts read) and before the parallel phase, and adds its K1
    launches to K1's and its K7 launches to K7's entry of the `kernels` line."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_data()") < src.index("phase_scripts(") < src.index("phase_parallel(")
    assert '+ scripts["k1_launches"]' in src and '+ scripts["k7_launches"]' in src
    phase = inspect.getsource(chip_smoke.phase_scripts)
    for name in ("dataset_manifest", "merge_datasets", "metrics_sweep", "trace_topops",
                 "cross_val_ckpts", "tiled_localize", "eval_run_ckpts", "post_train_eval",
                 "conv1x1_sweep", "tiled_fidelity", "chain_tune"):
        assert f'"{name}"' in phase, name
    assert chip_smoke.script_cmd("cross_val_ckpts", "-n", 6)[1:] == [
        "-m", "wavemamba_torch.scripts.cross_val_ckpts", "-n", "6"]


def test_scripts_phase_trains_the_xxl4_yml_cut_short(tmp_path, monkeypatch):
    """The scripts phase's run is the xxl4 yml on the generated set, cut to
    SCRIPTS_ITERS iterations that each log, save and validate, started from
    the yml's pretrained checkpoint; every other training setting as the yml
    has it."""
    monkeypatch.setattr(chip_smoke, "SCRIPTS_DIR", str(tmp_path))
    got = yaml_load(chip_smoke.scripts_train_yml(str(tmp_path / "proc")))
    want = yaml_load(chip_smoke.SCRIPTS_YML)
    assert got["train"]["total_iter"] == chip_smoke.SCRIPTS_ITERS == 2
    assert got["val"]["val_freq"] == 1 and got["logger"]["save_checkpoint_freq"] == 1
    assert got["datasets"]["val"]["dataroot_lq"] == str(tmp_path / "proc" / "val" / "input")
    assert got["path"]["pretrain_network_g"] == str(REPO / want["path"]["pretrain_network_g"])
    assert os.path.exists(got["path"]["pretrain_network_g"])
    assert got["train"]["ema_decay"] == want["train"]["ema_decay"] > 0  # the run saves net_g_ema_*
    assert json.loads(json.dumps(got["network_g"])) == json.loads(json.dumps(want["network_g"]))
    assert json.loads(json.dumps(got["val"]["metrics"])) == json.loads(json.dumps(want["val"]["metrics"]))


def test_art_attention_phase_runs_before_art_with_four_pad_classes():
    """The kernel's phase runs on the main path before ART's phase; the pad
    marks it reads its error under hold four classes in both calls, and its
    by-class helper writes every group's rows once (here through the plain
    version, on the CPU)."""
    import inspect

    import numpy as np
    import torch

    from wavemamba_torch.models.art import _classes
    from wavemamba_torch.ops.art_attention import art_attention_plain

    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_parallel(") < src.index("phase_art_attention(") < src.index("phase_art(")
    for kind, (groups, gh, gw) in chip_smoke.ART_ATTN_CALLS.items():
        marks = chip_smoke._art_pad_marks(kind)
        assert marks.shape == (groups, gh * gw) and len(_classes(marks)[0]) == 4
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(6, 2, 15, 32, generator=g) for _ in range(3))
    table = torch.randn(5 * 9, 2, generator=g)
    marks = np.zeros((6, 15), bool)
    marks[3:, -1] = True
    got, calls = chip_smoke._art_by_class(art_attention_plain, q, k, v, table, 3, 5, marks)
    assert calls == 2 and torch.isfinite(got).all()
    assert torch.allclose(got[:3], art_attention_plain(q, k, v, table, 3, 5)[:3], atol=1e-6)
