"""What `chip_smoke.py` reports without a card: the `kernels` line's top-level
errors of K1 and K2 are the float32 rows' own, the bf16 rows' in `bf16`; the
yml training phases' options are the shipped ymls' sections; the build log's
and the profile's readings."""

import importlib.util
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
