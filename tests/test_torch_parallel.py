"""Multi-GPU (`wavemamba_torch/parallel/`, the mesh argument of the trainer,
runner, device cache and pipelines, `tiled_apply_mesh`) against the JAX
package on the CPU.

The ranks are real processes over gloo: a module-scoped fixture starts the
2-rank run of `wavemamba_torch.scripts.multiproc_worker` once (every check,
and `train_pipeline` on a tiny yml), another the 4-rank run under torchrun
(the scan; the launcher's environment path of `parallel.initialize`). Each
rank writes what it computed; the tests hold it against JAX's functions on
`make_mesh(n)` over the suite's 8 virtual CPU devices, run as JAX's own
tests run them (the costly ones in threads from the module's start, so that
XLA compiles them side by side while the ranks run), and against one
process of the port. Tolerances are stated where they are used.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wavemamba_torch import convert, parallel
from wavemamba_torch.models import build_network, init_network, wavemamba_apply
from wavemamba_torch.models import tiling as ttiling
from wavemamba_torch.parallel.dist import local_init_method
from wavemamba_torch.runner import build_model
from wavemamba_torch.scripts import multiproc_worker as W
from wavemamba_torch.train import trainer as ttrain
from wavemamba_tpu.convert.torch_import import load_wavemamba_checkpoint
from wavemamba_tpu.data.device_cache import DeviceCachedLoader as JaxDeviceCachedLoader
from wavemamba_tpu.data.loader import EnlargedSampler as JaxEnlargedSampler
from wavemamba_tpu.data.paired_image_dataset import PairedImageDataset as JaxPairedImageDataset
from wavemamba_tpu.models import tiling as jtiling
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.ops.scan import selective_scan_chunked as jax_chunked
from wavemamba_tpu.parallel import mesh as jmesh
from wavemamba_tpu.parallel.seq_scan import selective_scan_seq_sharded as jax_seq_sharded
from wavemamba_tpu.train import trainer as jtrain

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TINY = jwm.WaveMambaConfig(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), scan_chunk=16)
# The train step's reference: the tiny config with JAX's plain 'ref' scan
# (the same recurrence as 'chunked', which XLA takes 14 s longer to compile).
JAX_TRAIN = jwm.WaveMambaConfig(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), remat=False,
                                scan_impl="ref")
# Data-parallel parameters and EMA against JAX's mesh step (see the train test).
PARAM_ATOL = 2e-5
# The sequence-sharded scan's gradients against JAX's, as tests/test_torch_remat.py
# holds gradients through a scan.
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
SCAN_INPUTS = ("u", "delta", "A", "Bs", "Cs", "D_skip", "delta_bias")


class _Ranks:
    """Rank processes started together; `results()` waits for them, fails
    with a rank's output where one exited non-zero, and loads each rank's
    pickle, in rank order."""

    def __init__(self, procs, out, world):
        self.procs, self.out, self.world, self._res = procs, out, world, None

    def results(self):
        if self._res is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=600)[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._res = []
            for r in range(self.world):
                with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                    self._res.append(pickle.load(f))
        return self._res


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}


def _worker(*args):
    """The worker's argv on the CPU (its default device is the card)."""
    return ["-m", "wavemamba_torch.scripts.multiproc_worker", "--device", "cpu", *args]


def _write_pngs(root, n=6, size=24):
    """`tests/test_torch_device_cache.py:_write_dataset`'s seeded PNG pairs."""
    rng = np.random.RandomState(3)
    for sub in ("gt", "input"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        gt = rng.randint(0, 256, (size, size, 3), np.uint8)
        cv2.imwrite(os.path.join(root, "gt", f"{i:03d}.png"), gt)
        cv2.imwrite(os.path.join(root, "input", f"{i:03d}.png"), (gt // 2).astype(np.uint8))


def _write_train_yml(data):
    """A tiny yml (wf 8, batch 1 a rank of 32x32 crops, 2 iterations, the
    checkpoint at 2) over a seeded PNG folder."""
    rs = np.random.RandomState(0)
    for sub in ("gt", "input"):
        os.makedirs(os.path.join(data, "train", sub))
    for i in range(4):
        gt = (rs.rand(40, 48, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(data, "train", "gt", f"{i:03d}.png"), gt)
        cv2.imwrite(os.path.join(data, "train", "input", f"{i:03d}.png"), (gt * 0.3).astype(np.uint8))
    opt = {"name": "ranks", "model_type": "FeMaSRModel", "scale": 1, "manual_seed": 0,
           "datasets": {"train": {
               "name": "t", "type": "PairedImageDataset",
               "dataroot_gt": os.path.join(data, "train", "gt"),
               "dataroot_lq": os.path.join(data, "train", "input"),
               "io_backend": {"type": "disk"}, "gt_size": 32, "geometric_augs": True,
               "use_native": False, "batch_size_per_gpu": 1, "num_worker_per_gpu": 1,
               "dataset_enlarge_ratio": 2}},
           "network_g": {k: v for k, v in W.TINY.items()},
           "path": {"pretrain_network_g": None, "resume_state": None},
           "train": {"optim_g": {"type": "AdamW", "lr": 1e-3}, "total_iter": 2, "ema_decay": 0.9,
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}},
           "logger": {"print_freq": 1, "save_checkpoint_freq": 2, "use_tb_logger": False}}
    with open(os.path.join(data, "train.yml"), "w") as f:
        f.write(yaml.safe_dump(opt))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """Every check of the worker on 2 gloo ranks, started once. The weights
    are the port's seeded init of the tiny config (train and tiles), written
    as a `.pth` file that both packages load."""
    data = str(tmp_path_factory.mktemp("data2"))
    model = init_network(W.TINY, torch.Generator().manual_seed(0), device="cpu")
    torch.save({"params": model.state_dict()}, os.path.join(data, "tiny.pth"))
    _write_pngs(os.path.join(data, "pngs"))
    _write_train_yml(data)
    out = str(tmp_path_factory.mktemp("out2"))
    init = local_init_method()
    procs = [subprocess.Popen([sys.executable, *_worker("--init", init, "--world", "2", "--rank",
                                                        str(r), "--out", out, "--data", data)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    ranks = _Ranks(procs, out, 2)
    ranks.data = data
    yield ranks
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_ranks(request):
    """Start both rank runs and the JAX side before the first test, so that
    they run together."""
    request.getfixturevalue("ranks2")
    request.getfixturevalue("ranks4")
    request.getfixturevalue("jax_refs")


@pytest.fixture(scope="module")
def weights(ranks2):
    """The JAX parameter tree of the ranks' weights file, as numpy (each test
    makes its own device arrays: the train step donates its state)."""
    return jax.tree_util.tree_map(np.asarray, load_wavemamba_checkpoint(
        os.path.join(ranks2.data, "tiny.pth")))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """The scan on 4 gloo ranks, launched by torchrun (the group from its
    environment)."""
    out = str(tmp_path_factory.mktemp("out4"))
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node=4", *_worker("--out", out, "--checks", "init,scan")],
                            cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield _Ranks([proc], out, 4)
    if proc.poll() is None:
        proc.kill()


def _ranks(request, n):
    return request.getfixturevalue(f"ranks{n}").results()


def _jax_train(weights):
    """JAX's mesh step, two steps on the 4-image batches of the ranks:
    (losses, parameters, EMA), the last two as the port's state dicts."""
    mesh = jmesh.make_mesh(2)
    tcfg = jtrain.TrainConfig(**W.TCFG)
    state = jmesh.replicate(mesh, jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, weights), tcfg))
    step = jtrain.make_train_step(JAX_TRAIN, tcfg, mesh)
    losses = []
    for lq, gt in W.train_batches(2):
        batch = jmesh.shard_batch(mesh, {"lq": lq, "gt": gt})
        state, m = step(state, batch["lq"], batch["gt"])
        losses.append({k: float(v) for k, v in m.items()})
    return losses, *(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state[k]))
                     for k in ("params", "ema"))


def _jax_scan(n):
    """JAX's seq-sharded scan on `make_mesh(n)` and its chunked scan, of the
    ranks' cases: ({key: [references]}, the ragged L's message)."""
    mesh = jmesh.make_mesh(n)
    args = [jnp.asarray(a) for a in W.scan_case(0)]
    slow = [jnp.asarray(a) for a in W.scan_case(1, b=1, k=1, length=512, d=4, n=2, slow=True)]
    wants = {"scan": [np.asarray(jax_seq_sharded(*args, mesh=mesh, chunk=16)),
                      np.asarray(jax_chunked(*args, chunk=16))],
             "scan_slow": [np.asarray(jax_chunked(*slow, chunk=32))]}
    ct = jnp.asarray(W.scan_cotangent())
    loss = lambda *a: jnp.sum(jax_seq_sharded(*a, mesh=mesh, chunk=16) * ct)  # noqa: E731
    wants["scan_grads"] = [np.asarray(g) for g in
                           jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*args)]
    with pytest.raises(ValueError) as err:
        jax_seq_sharded(*map(jnp.asarray, W.scan_case(2, length=255)), mesh=mesh, chunk=16)
    return wants, str(err.value)


def _jax_seq_train(weights):
    """JAX's mesh step with the tiny config's scan sequence-sharded over
    `make_mesh(2)` (`scan_impl='seq_sharded'`, `scan_mesh`), one step on the
    ranks' first global batch: (metrics, parameters as the port's state
    dict)."""
    mesh = jmesh.make_mesh(2)
    cfg = jwm.WaveMambaConfig(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1), remat=False,
                              scan_impl="seq_sharded", scan_chunk=16, scan_mesh=mesh)
    tcfg = jtrain.TrainConfig(**W.TCFG)
    state = jmesh.replicate(mesh, jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, weights), tcfg))
    lq, gt = W.train_batches(2)[0]
    batch = jmesh.shard_batch(mesh, {"lq": lq, "gt": gt})
    state, m = jtrain.make_train_step(cfg, tcfg, mesh)(state, batch["lq"], batch["gt"])
    return ({k: float(v) for k, v in m.items()},
            convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state["params"])))


def _jax_tiles(weights):
    return jtiling.tiled_apply_mesh(jwm.wavemamba_apply, jax.tree_util.tree_map(jnp.asarray, weights),
                                    JAX_TINY, W.tile_image(), jmesh.make_mesh(2), tile_size=48,
                                    tile_pad=8)


@pytest.fixture(scope="module")
def jax_refs(weights):
    """The JAX side of the train, scan and tile tests, each a future of a
    thread started with the module."""
    with ThreadPoolExecutor(5) as pool:
        yield {"train": pool.submit(_jax_train, weights), "scan2": pool.submit(_jax_scan, 2),
               "scan4": pool.submit(_jax_scan, 4), "tiles": pool.submit(_jax_tiles, weights),
               "seq_train": pool.submit(_jax_seq_train, weights)}


# ------------------------------------------------------------------ one process

def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    """No arguments and no launcher environment: no group, the device as
    asked, one rank of one, no mesh; the mesh-less helpers pass things
    through."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert parallel.get_dist_info() == (0, 1) and parallel.is_master()
    assert parallel.make_mesh() is None
    with pytest.raises(ValueError, match="without a process group"):
        parallel.make_mesh(2)
    x = torch.arange(6.0).view(3, 2)
    assert parallel.shard_batch(None, x) is x and parallel.replicate(None, x) is x
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        parallel.initialize()
    # the JAX package exports the same names, less the two sharding objects
    import wavemamba_tpu.parallel as jparallel

    assert set(parallel.__all__) - {"barrier"} == set(jparallel.__all__) - {"batch_sharding",
                                                                            "replicated"}


# --------------------------------------------------------------- the ranks' checks

def test_data_parallel_step_matches_jax_mesh_step(request, jax_refs):
    """Two steps of the tiny config on 2 ranks x 2 images from the same
    weights, against `make_train_step(cfg, tcfg, make_mesh(2))` on the same
    4-image batches (EMA 0.999 and the clip on: the clip sees the averaged
    gradients). The averaged loss of each step rtol 1e-5, as
    `tests/test_train.py`'s sharded step (measured 1.5e-6); parameters and
    EMA after the steps within PARAM_ATOL = 2e-5 (measured 8.3e-6 and
    9.5e-7; AdamW divides by sqrt(v), so a last-bit difference in a
    near-zero gradient moves a parameter by a fraction of lr). The planted
    fault, each rank stepping on its own gradients, is 2.0e-3 away and must
    stay beyond the tolerance. A rank whose gradients were not averaged
    drifts from the other: the ranks end with the same bits."""
    losses, want_params, want_ema = jax_refs["train"].result()
    got = _ranks(request, 2)
    for res in got:
        for mine, theirs in zip(res["train_losses"], losses):
            assert set(mine) == set(theirs)
            for k in mine:
                np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, err_msg=k)
        assert max(np.abs(res["train_params"][k] - want_params[k].numpy()).max()
                   for k in want_params) <= PARAM_ATOL
        assert max(np.abs(res["train_ema"][k] - want_ema[k].numpy()).max()
                   for k in want_ema) <= PARAM_ATOL
        assert max(np.abs(res["train_params_unaveraged"][k] - want_params[k].numpy()).max()
                   for k in want_params) > 10 * PARAM_ATOL
    for k, v in got[0]["train_params"].items():
        np.testing.assert_array_equal(v, got[1]["train_params"][k], err_msg=k)
    # `make_eval_step(mesh)` on the global batch: every rank gets the whole
    # output, one process's forward of the trained weights within 1e-5
    # (a rank's batch of 2 against one of 4 takes other float32 sums)
    model = build_network(W.TRAIN_NET, {k: torch.from_numpy(v) for k, v in
                                     got[0]["train_params"].items()}, device="cpu")
    lq = torch.from_numpy(W.train_batches(2)[0][0])
    want_eval = ttrain.make_eval_step()(model, lq).numpy()
    for res in got:
        assert res["eval"].shape == want_eval.shape == (4, 32, 32, 3)
        np.testing.assert_allclose(res["eval"], want_eval, atol=1e-5, rtol=0)


def test_master_only(request):
    """Rank 0 runs the function, the others get None; in one process, rank 0."""
    assert parallel.master_only(lambda: "ran")() == "ran"
    got = _ranks(request, 2)
    assert [r["master_only"] for r in got] == [0, None]
    assert [r["device"] for r in got] == ["cpu", "cpu"]
    # the logger's rank-0 rule: rank 1 logs errors only
    assert got[0]["logger_level"] == 20 and got[1]["logger_level"] == 40


def test_sampler_rank_shards(request):
    """Each rank's `EnlargedSampler` shard is JAX's, the shards are disjoint
    in position and cover the enlarged epoch."""
    got = _ranks(request, 2)
    for r, res in enumerate(got):
        want = JaxEnlargedSampler(10, 2, r, 2)
        want.set_epoch(3)
        assert res["sampler"] == list(iter(want))
    assert len(got[0]["sampler"]) + len(got[1]["sampler"]) == 20
    assert set(got[0]["sampler"]) | set(got[1]["sampler"]) <= set(range(10))


@pytest.mark.parametrize("n", [2, 4])
def test_seq_sharded_scan_matches_jax(request, jax_refs, n):
    """`selective_scan_seq_sharded` on n ranks against JAX's on `make_mesh(n)`
    and against the one-device chunked scan (b=2, k=2, l=256, d=8, n=4,
    chunk 16), rtol = atol = 3e-5 as `tests/test_seq_scan.py` (measured
    2.4e-6 at 2 ranks); JAX's
    long-memory case (A x 0.01, l=512, chunk 32) against the chunked scan,
    as JAX's test holds its own; every rank holds the whole y; an L that
    does not divide raises JAX's message."""
    wants, ragged = jax_refs[f"scan{n}"].result()
    got = _ranks(request, n)
    for key, want in wants.items():
        if key == "scan_grads":
            continue
        for res in got:
            assert res[key].shape == want[0].shape
            for w in want:
                np.testing.assert_allclose(res[key], w, rtol=3e-5, atol=3e-5)
    assert all(r["scan_ragged_error"] == ragged for r in got)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_sharded_scan_grads_match_jax(request, jax_refs, n):
    """The gradients of every input of `selective_scan_seq_sharded` on n
    ranks, for one seeded cotangent, against `jax.grad` of JAX's on
    `make_mesh(n)` (the scan test's case), rtol 5e-4 / atol 5e-5 as
    `tests/test_torch_remat.py` holds gradients through a scan; every rank
    holds the same whole gradients, bit for bit. The differentiable call's
    forward has the no_grad call's bits (the forward is unchanged)."""
    wants, _ = jax_refs[f"scan{n}"].result()
    got = _ranks(request, n)
    for res in got:
        assert res["scan_grad_forward_same_bits"]
        for name, mine, want in zip(SCAN_INPUTS, res["scan_grads"], wants["scan_grads"]):
            assert mine.shape == want.shape, name
            np.testing.assert_allclose(mine, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
        for mine, first in zip(res["scan_grads"], got[0]["scan_grads"]):
            np.testing.assert_array_equal(mine, first)


def test_seq_sharded_step_matches_jax_and_one_process(request, jax_refs):
    """One step of the tiny config with `scan_impl: seq_sharded` on 2 ranks
    (each handed 2 of the 4 images; the step gathers them) against JAX's mesh
    step with its scan sharded over `make_mesh(2)`, and against the port's
    one-process 'chunked' step on the 4 images: the parameters within
    PARAM_ATOL, the loss rtol 1e-5 (the data-parallel test's tolerances).
    Both ranks end with the same bits."""
    want_metrics, want_jax = jax_refs["seq_train"].result()
    got = _ranks(request, 2)
    weights = torch.load(os.path.join(request.getfixturevalue("ranks2").data, "tiny.pth"))["params"]
    one = build_network(W.TRAIN_NET, weights, device="cpu")
    tcfg = ttrain.TrainConfig(**W.TCFG)
    lq, gt = (torch.from_numpy(a) for a in W.train_batches(2)[0])
    _, metrics = ttrain.make_train_step(tcfg)(ttrain.create_train_state(one, tcfg), lq, gt)
    want_one = one.state_dict()
    for res in got:
        for k, v in want_metrics.items():
            np.testing.assert_allclose(res["seq_train_loss"][k], v, rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(res["seq_train_loss"][k], float(metrics[k]), rtol=1e-5,
                                       err_msg=k)
        params = res["seq_train_params"]
        assert max(np.abs(params[k] - want_jax[k].numpy()).max() for k in want_jax) <= PARAM_ATOL
        assert max(np.abs(params[k] - want_one[k].numpy()).max() for k in want_one) <= PARAM_ATOL
    for k, v in got[0]["seq_train_params"].items():
        np.testing.assert_array_equal(v, got[1]["seq_train_params"][k], err_msg=k)


def test_seq_sharded_eval_and_validation_run_every_row_on_every_rank(request):
    """With `scan_impl: seq_sharded` the ranks must hold the same rows: the
    eval step runs the whole global batch of 4 on each rank and the runner's
    validation every image on each rank (5 images, not shared out). Against
    one process with 'chunked' on the same weights: the outputs 3e-5 (the
    model test's tolerance), the metrics rtol 1e-4 (PSNR / SSIM of the
    quantized outputs); both ranks return the same averages."""
    got = _ranks(request, 2)
    weights = torch.load(os.path.join(request.getfixturevalue("ranks2").data, "tiny.pth"))["params"]
    one = build_network(W.TRAIN_NET, weights, device="cpu")
    want = ttrain.make_eval_step()(one, torch.from_numpy(W.train_batches(2)[0][0])).numpy()
    opt = W.val_opt("cpu")
    opt["network_g"] = W.TRAIN_NET
    want_val, _ = build_model(opt).validation(W.val_images(), current_iter=1)
    for res in got:
        assert res["seq_eval"].shape == want.shape == (4, 32, 32, 3)
        np.testing.assert_allclose(res["seq_eval"], want, rtol=3e-5, atol=3e-5)
        assert set(res["seq_val"]) == set(want_val) == {"psnr", "ssim"}
        for k, v in want_val.items():
            np.testing.assert_allclose(res["seq_val"][k], v, rtol=1e-4, err_msg=k)
    assert got[0]["seq_val"] == got[1]["seq_val"]


def test_seq_sharded_model_matches_one_process_chunked(request):
    """The model with `scan_impl: seq_sharded` over 2 ranks against the same
    weights' one-process 'chunked' forward, 3e-5 as JAX's own test: 48x48,
    and 40x56, whose level-3 L (35) is padded to the ranks."""
    got = _ranks(request, 2)
    one = init_network({**W.SMALL, "scan_impl": "chunked", "scan_chunk": 8},
                       torch.Generator().manual_seed(0), device="cpu", train=False)
    for i, x in enumerate(W.model_images()):
        want = wavemamba_apply(one, torch.from_numpy(x)).numpy()
        for res in got:
            assert res["model"][i].shape == x.shape
            np.testing.assert_allclose(res["model"][i], want, rtol=3e-5, atol=3e-5)


def test_tiled_apply_mesh_matches_jax_and_one_process(request, jax_refs):
    """`tiled_apply_mesh` over 2 ranks (6 tiles in a batch of 8, 4 a rank)
    against JAX's over `make_mesh(2)` (1e-5, the port's float32 forward
    against JAX's, as the runner's tiles) and the port's one-process
    `tiled_apply` (1e-5: a rank's batch of 4 against one of 8 takes other
    float32 sums); every rank holds the whole frame."""
    img = W.tile_image()
    want_jax = jax_refs["tiles"].result()
    model = build_network(W.TINY, torch.load(os.path.join(request.getfixturevalue("ranks2").data,
                                                          "tiny.pth"))["params"], device="cpu")
    want_one = ttiling.tiled_apply(lambda t: wavemamba_apply(model, torch.from_numpy(t)).numpy(),
                                   img, tile_size=48, tile_pad=8)
    got = _ranks(request, 2)
    for res in got:
        assert res["tile_calls"] == [(4, 64, 64, 3)]
        np.testing.assert_allclose(res["tiles"], want_jax, atol=1e-5, rtol=0)
        np.testing.assert_allclose(res["tiles"], want_one, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0]["tiles"], got[1]["tiles"])


def test_validation_averages_are_global(request):
    """Validation of 5 images shared out round-robin (3 and 2): both ranks
    return the same averages, those of one process over all 5, rtol 1e-12
    (float64 sums of the same float values)."""
    got = _ranks(request, 2)
    one, _ = build_model(W.val_opt("cpu")).validation(W.val_images(), current_iter=1)
    assert got[0]["val"] == got[1]["val"]
    assert set(got[0]["val"]) == set(one) == {"psnr", "ssim"}
    for k, v in one.items():
        np.testing.assert_allclose(got[0]["val"][k], v, rtol=1e-12)


def test_device_cache_slices_match_jax_mesh_loader(request):
    """The ranks' slices of each global batch of 4, put together in rank
    order, against JAX's `DeviceCachedLoader(mesh=make_mesh(2))` on the same
    PNG folder, seed, unsharded sampler and epoch: bit for bit, paths too."""
    got = _ranks(request, 2)
    ranks2 = request.getfixturevalue("ranks2")
    ds = JaxPairedImageDataset(W.cache_opt(os.path.join(ranks2.data, "pngs")))
    ref = JaxDeviceCachedLoader(ds, 4, sampler=JaxEnlargedSampler(len(ds.paths), 1, 0, 2), seed=7,
                                mesh=jmesh.make_mesh(2))
    ref.set_epoch(1)
    want = list(ref)
    assert len(want) == len(got[0]["cache"]) == len(got[1]["cache"]) == 3
    for b, w in enumerate(want):
        parts = [res["cache"][b] for res in got]
        assert all(p["lq"].shape == (2, 16, 16, 3) for p in parts)
        for key in ("lq", "gt"):
            np.testing.assert_array_equal(np.concatenate([p[key] for p in parts]),
                                          np.asarray(w[key]))
        assert parts[0]["lq_path"] + parts[1]["lq_path"] == w["lq_path"]


def test_train_pipeline_on_two_ranks(request):
    """`train_pipeline` on 2 gloo ranks (batch 1 a rank, 2 iterations): rank
    0 alone writes the checkpoints (at iteration 2 and the latest), both
    ranks end with the same parameters, and the files hold them."""
    from wavemamba_torch.checkpoint import load_network

    got = _ranks(request, 2)
    assert got[1]["pipeline_writes"] == []
    assert sorted(set(got[0]["pipeline_writes"])) == ["net_g", "net_g_ema"]
    for k, v in got[0]["pipeline_params"].items():
        np.testing.assert_array_equal(v, got[1]["pipeline_params"][k], err_msg=k)
    exp = os.path.join(request.getfixturevalue("ranks2").data, "experiments", "ranks")
    assert sorted(os.listdir(os.path.join(exp, "models"))) == [
        "net_g_2.pth", "net_g_ema_2.pth", "net_g_ema_latest.pth", "net_g_latest.pth"]
    saved = load_network(os.path.join(exp, "models", "net_g_latest.pth"), device="cpu")
    for k, v in got[0]["pipeline_params"].items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
