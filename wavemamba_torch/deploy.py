"""Deployment artifacts: serving WaveMamba from one file, without its model
code or weights on the side. The counterpart of `wavemamba_tpu/deploy.py`.

`export_model` turns a state dict into a self-contained archive: the weights
once, and one `torch.export` program per static input shape. A serving
process needs only this module and the op that runs kernel K1
(`ops/scan_cuda.py`), not the model source, the converter or the config
system, and it traces nothing.

Archive layout (a single ``.wmt`` zip; ``.wmx`` is the JAX package's)::

    manifest.json           versioning, config echo, shapes, platforms, and
                            each program's trace and save seconds (`build`)
    params.npz              flat weight list in state-dict order (p000000, ...)
    programs/{H}x{W}.pt2    `torch.export.save` of the program for one bucket
    programs/tile.pt2       the fixed-shape tile program (``tile=...``)

Programs take ``(flat_params, x)``, the weights as a flat positional tuple in
state-dict order, as the JAX programs take theirs, so the weights are stored
once, guarded by `params_sha256`, and no program holds a copy. x is NHWC,
float32 in [0, 1] or, with ``io_dtype='uint8'``, bytes.

With ``mesh_devices=N`` the tile program is traced at the per-rank batch,
``tile['batch'] // N``, and serves only under a process group of N ranks
(`torchrun --nproc_per_node=N`, `parallel.initialize`): each rank replays
its share of every tile batch through its own CUDA graph, the shares are
gathered in rank order (`parallel.mesh.gather_rows`) and every rank returns
the whole frame (`models.tiling.tiled_apply_mesh`), as the JAX package's
program runs under ``NamedSharding(mesh, PartitionSpec('data'))``.

Programs are traced on the CPU. By default the artifact is portable
(``platforms=('cpu', 'cuda')``): a configured kernel scan
(``scan_impl='pallas*'``) is swapped for the plain 'par' scan, the same
swap as the JAX package's. ``allow_custom_calls=True`` keeps kernel K1 as one
node of its registered op (`scan_cuda.ss2d_scan_pair_fwd`) and narrows the
default platforms to ``('cuda',)``; the op takes the plain version on a CPU
tensor, so listing ``'cpu'`` as well gives an artifact that serves on both.
At load on the card each program is moved there by
`torch.export.passes.move_to_device_pass` (the manifest's `placement`).

On the card each program runs as one CUDA graph: captured at its first call
(a warm-up on a side stream first, which builds K1 and settles cuDNN's
choices), replayed after that, with a static input buffer and the weights
placed once. Each captured shape holds its own memory pool. On the CPU the
program runs as it is. Serving never gives way to eager modules, to the plain
scan or to the CPU: a capture or a build that fails raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from wavemamba_torch.device import resolve_device
from wavemamba_torch.models.tiling import tiled_apply, tiled_apply_mesh
from wavemamba_torch.ops import scan_cuda

FORMAT_VERSION = 1
SUFFIX = ".wmt"
PLATFORMS = ("cpu", "cuda")
# The plain scan that replaces a kernel scan in a portable artifact: the
# fully parallel one, as in the JAX package (and `WaveMambaConfig.fast_xla()`).
_PORTABLE_SCAN = "par"
_PLACEMENT = "traced on the CPU; torch.export.passes.move_to_device_pass at load on the card"


def enable_compilation_cache(cache_dir) -> Path:
    """Build and look up the port's kernels in `cache_dir`
    (`scan_cuda.BUILD_DIR`, through which every kernel library builds).

    A library's name is keyed by the hash of its source, headers and `nvcc`
    flags, so the first process builds K1 there and every later one loads
    the library instead of running `nvcc`: the counterpart of the JAX
    package's persistent XLA cache. Call it before the first kernel launch,
    or pass ``compile_cache=`` to `ExportedModel.load`."""
    path = Path(cache_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    scan_cuda.BUILD_DIR = path
    return path


def _clean_config(cfg):
    """Config echo for the manifest: serializable fields only (not
    `scan_mesh`, a process-local object)."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "scan_mesh"}
    for k, v in list(d.items()):
        if isinstance(v, tuple):
            d[k] = list(v)
    return d


def _params_digest(flat):
    h = hashlib.sha256()
    for p in flat:
        h.update(np.ascontiguousarray(np.asarray(p)).tobytes())
    return h.hexdigest()


def _tile_ext(tile_size, tile_pad, pad_multiple):
    """The fixed padded tile shape used by `models.tiling.tiled_apply`."""
    ext = tile_size + 2 * tile_pad
    return ext + (-ext) % pad_multiple


class _Program(torch.nn.Module):
    """What `torch.export` traces: (flat_params, x NHWC) -> y NHWC, the model
    run with `flat_params` in place of its weights (`functional_call`). The
    model is held outside the module's registry, so the program lifts none of
    its weights."""

    def __init__(self, model, names, io_dtype):
        super().__init__()
        self.__dict__["model"] = model
        self.names, self.io_dtype = names, io_dtype

    def forward(self, flat_params, x):
        if self.io_dtype == "uint8":
            x = x.float() / 255.0
        params = dict(zip(self.names, flat_params))
        y = torch.func.functional_call(self.model, params, (x.permute(0, 3, 1, 2),))
        y = y.permute(0, 2, 3, 1)
        if self.io_dtype == "uint8":
            # batch2img's quantization on the device: torch.round is half to even.
            return torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return y.contiguous()


def _drop_no_op_casts(ep):
    """Erase what the trace records but the program never needs: the casts
    of float32 weights to a float32 activation's dtype (`ops/nn.py`'s
    modules cast each weight where it is used) and the metadata asserts
    beside them, about a third of a float32 program's nodes, and the share
    of its save and load time that they take."""
    aten, graph = torch.ops.aten, ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and getattr(node.args[0].meta.get("val"), "dtype", None) == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def export_model(state_dict, cfg, shapes, out_path, *, batch=1, platforms=None,
                 allow_custom_calls=False, tile=None, mesh_devices=1, io_dtype="float32"):
    """Serialize the model of `cfg` with `state_dict` for each ``(H, W)``.

    Args:
        state_dict: the model's weights (`checkpoint.load_network`), on any device.
        cfg: `WaveMambaConfig`. A kernel scan ('pallas*') becomes the portable
            'par' scan unless `allow_custom_calls`.
        shapes: iterable of ``(H, W)`` static input shapes. Callers pad to a
            multiple of 128 like the reference; this is not re-checked (tiles
            only need x8).
        out_path: destination ``.wmt`` file.
        batch: static batch dimension of every program.
        platforms: the devices the artifact serves on, of ``('cpu', 'cuda')``.
            Default both, or ``('cuda',)`` with `allow_custom_calls`.
        allow_custom_calls: keep K1 as its registered op
            (``scan_impl='pallas_fused'``; the unfused kernels K3 / K4 and the
            fused conv chains have no registered op and are refused).
        tile: optional ``{"size": 240, "pad": 16, "batch": 8, "pad_multiple": 8}``:
            also export one fixed-shape tile program, so the artifact serves
            frames larger than any whole-frame bucket through
            `ExportedModel.tiled`.
        mesh_devices: shard the tile program over this many ranks (needs
            `tile`, whose batch must divide over them): the program is traced
            at ``tile['batch'] // mesh_devices`` and served under a process
            group of that many ranks.
        io_dtype: ``"float32"`` (default) or ``"uint8"``: programs take and
            return bytes, the conversion on the device, quantized exactly
            like the save path (clip to [0, 1], * 255, round half to even).
    """
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import set_scan

    if io_dtype not in ("float32", "uint8"):
        raise ValueError(f"io_dtype must be 'float32' or 'uint8', got {io_dtype!r}")
    if cfg.conv_impl == "fused":
        raise NotImplementedError("conv_impl='fused' (the chain kernels K6 / K7) has no registered "
                                  "op to export; export conv_impl='xla' (the same weights)")
    if cfg.scan_impl.startswith("pallas") and not allow_custom_calls:
        cfg = dataclasses.replace(cfg, scan_impl=_PORTABLE_SCAN)
    if allow_custom_calls and cfg.scan_impl == "pallas":
        raise NotImplementedError("scan_impl='pallas' (kernels K3 / K4) has no registered op to "
                                  "export; allow_custom_calls keeps K1 ('pallas_fused')")
    if platforms is None:
        platforms = ("cuda",) if allow_custom_calls else PLATFORMS
    platforms = tuple(platforms)
    if not platforms or set(platforms) - set(PLATFORMS):
        raise ValueError(f"platforms must be some of {PLATFORMS}, got {platforms}")
    shapes = [tuple(map(int, s)) for s in shapes]
    if tile is not None:
        tile = {"size": int(tile.get("size", 240)), "pad": int(tile.get("pad", 16)),
                "batch": int(tile.get("batch", 8)),
                "pad_multiple": int(tile.get("pad_multiple", 8))}
    mesh_devices = int(mesh_devices)
    if mesh_devices > 1:
        if tile is None:
            raise ValueError("mesh_devices > 1 shards the tile program; pass tile=... as well")
        if tile["batch"] % mesh_devices:
            raise ValueError(f"tile batch {tile['batch']} must divide over {mesh_devices} devices")

    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(cfg)}, sd, device="cpu")
    model.requires_grad_(False)
    if cfg.scan_impl == "pallas_fused":
        set_scan(model, scan_cuda.ss2d_scan_pair_op)
    names = list(model.state_dict())
    flat = tuple(t.contiguous() for t in model.state_dict().values())
    program = _Program(model, names, io_dtype)
    x_dtype = torch.uint8 if io_dtype == "uint8" else torch.float32

    build = {"trace_s": {}, "save_s": {}}  # seconds on the build host, per program

    def trace(name, shape):
        t0 = time.perf_counter()
        ep = torch.export.export(program, (flat, torch.zeros(shape, dtype=x_dtype)), strict=False)
        _drop_no_op_casts(ep)
        t1 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        build["trace_s"][name], build["save_s"][name] = t1 - t0, time.perf_counter() - t1
        return buf.getvalue()

    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "model": "WaveMamba",
        "config": _clean_config(cfg),
        "batch": int(batch),
        "shapes": [list(s) for s in shapes],
        "tile": tile,
        "mesh_devices": mesh_devices,
        # the batch of the traced tile program: each rank's share of tile["batch"]
        "tile_rank_batch": None if tile is None else tile["batch"] // mesh_devices,
        "io_dtype": io_dtype,
        "platforms": list(platforms),
        "placement": _PLACEMENT,
        "n_params": len(flat),
        "param_bytes": int(sum(p.numel() * p.element_size() for p in flat)),
        "params_sha256": _params_digest(p.numpy() for p in flat),
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        buf = io.BytesIO()
        np.savez(buf, **{f"p{i:06d}": p.numpy() for i, p in enumerate(flat)})
        zf.writestr("params.npz", buf.getvalue())
        for H, W in shapes:
            zf.writestr(f"programs/{H}x{W}.pt2", trace(f"{H}x{W}", (batch, H, W, cfg.in_chn)))
        if tile is not None:
            ext = _tile_ext(tile["size"], tile["pad"], tile["pad_multiple"])
            zf.writestr("programs/tile.pt2", trace("tile", (tile["batch"] // mesh_devices, ext, ext,
                                                            cfg.in_chn)))
        manifest["build"] = build
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
    return manifest


class _Runner:
    """One program on one device. On the CPU it runs as it is. On the card it
    is captured into a CUDA graph at its first call and replayed after that:
    `replays` counts the replays, `k1_in_graph` the K1 launches the capture
    recorded (each replay runs them again without passing through the
    wrapper's count)."""

    def __init__(self, module, flat, device):
        self.module, self.flat, self.device = module, flat, device
        self.graph = self.static_x = self.static_y = None
        self.replays = self.k1_in_graph = 0

    def run(self, x: torch.Tensor):
        """The program's output for `x` (on the CPU or on the card) on the
        program's device, enqueued: on the card the graph's static output,
        which the next replay overwrites (stream order keeps a copy or a
        collective enqueued before it safe)."""
        if self.device.type == "cpu":
            with torch.no_grad():
                return self.module(self.flat, x)
        if self.graph is None:
            self._capture(x)
        else:
            self.static_x.copy_(x, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.static_y

    def launch(self, x: np.ndarray):
        """Enqueue the program on `x`: (the output on the host, the event
        after its copy there, or None on the CPU)."""
        src = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cpu":
            return self.run(src), None
        y = self.run(src.pin_memory())
        # A pinned buffer per call: the next replay writes the same static
        # output, and stream order keeps it behind this copy.
        out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        out.copy_(y, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, done

    def _capture(self, src):
        # on this program's card, whichever is current (ranks that share a host)
        with torch.cuda.device(self.device):
            self.static_x = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            self.static_x.copy_(src, non_blocking=True)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side), torch.no_grad():
                self.module(self.flat, self.static_x)  # builds K1, settles cuDNN's choices
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = scan_cuda.ss2d_scan_pair.launches
            with torch.no_grad(), torch.cuda.graph(graph):
                self.static_y = self.module(self.flat, self.static_x)
            self.k1_in_graph = scan_cuda.ss2d_scan_pair.launches - before
            self.graph = graph


class ExportedModel:
    """A loaded ``.wmt`` artifact: pad -> run the right program -> crop."""

    def __init__(self, manifest, flat_params, programs, tile_program=None, device="cuda"):
        self.manifest = manifest
        self.device = resolve_device(device)
        flat = tuple(torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                     for p in flat_params)  # placed once
        self.runners = {shape: _Runner(m, flat, self.device) for shape, m in programs.items()}
        if tile_program is not None:
            self.runners["tile"] = _Runner(tile_program, flat, self.device)
        self.shapes = sorted(programs)
        self.io_dtype = manifest.get("io_dtype", "float32")
        self._mesh = None  # the process group's mesh, made at the first sharded `tiled`

    @classmethod
    def load(cls, path, compile_cache=None, device="cuda"):
        dev = resolve_device(device)
        if str(path).endswith(".wmx"):
            raise ValueError(f"{path}: .wmx artifacts are the JAX package's "
                             "(wavemamba_tpu/deploy.py); the port serves its own "
                             f"{SUFFIX} artifacts (wavemamba_torch/deploy.py)")
        if compile_cache is not None:
            enable_compilation_cache(compile_cache)
        with zipfile.ZipFile(path, "r") as zf:
            manifest = json.loads(zf.read("manifest.json"))
            if manifest["format_version"] > FORMAT_VERSION:
                raise ValueError(f"artifact format {manifest['format_version']} is newer than "
                                 f"this loader ({FORMAT_VERSION})")
            built_with = manifest.get("torch_version")
            if built_with and built_with != torch.__version__:
                # Record the drift: a load failure or a numeric deviation
                # should be attributable at a glance.
                logging.getLogger("wavemamba_torch").warning(
                    "%s was exported with torch %s; this host runs torch %s (re-export to "
                    "clear this warning)", path, built_with, torch.__version__)
            with np.load(io.BytesIO(zf.read("params.npz"))) as npz:
                flat = tuple(npz[f"p{i:06d}"] for i in range(manifest["n_params"]))
            want = manifest.get("params_sha256")
            if want is not None and _params_digest(flat) != want:
                raise ValueError(f"{path}: weight payload does not match the manifest "
                                 "checksum: corrupt or tampered artifact")

            def program(name):
                ep = torch.export.load(io.BytesIO(zf.read(f"programs/{name}.pt2")))
                if dev.type != "cpu":
                    # No fallback: a torch without the pass cannot serve the artifact here.
                    from torch.export.passes import move_to_device_pass

                    ep = move_to_device_pass(ep, dev)
                return ep.module()

            programs = {(H, W): program(f"{H}x{W}") for H, W in manifest["shapes"]}
            tile_program = program("tile") if manifest.get("tile") is not None else None
        return cls(manifest, flat, programs, tile_program, device=dev)

    def _shape_for(self, h, w):
        fits = [(H, W) for H, W in self.shapes if H >= h and W >= w]
        if not fits:
            raise ValueError(f"input {h}x{w} exceeds every exported shape {self.shapes}; "
                             "re-export with a larger bucket or tile the input")
        return min(fits, key=lambda s: s[0] * s[1])

    def _to_io(self, x):
        """Host pixels in the programs' dtype (a uint8 artifact takes float
        [0, 1] too, quantized with the save path's exact math)."""
        x = np.asarray(x)
        if self.io_dtype == "uint8":
            if x.dtype == np.uint8:
                return x
            return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)
        return np.asarray(x, np.float32)

    def __call__(self, x):
        """Enhance ``(B, h, w, C)``; returns the same spatial shape.

        float32 artifacts take and return float32 in [0, 1]; uint8 artifacts
        take uint8 (or float [0, 1], quantized on the host) and return uint8,
        the conversion on the device. ``B`` must equal the exported batch;
        spatial dims reflect-pad up to the smallest exported program that
        fits (the reference's 128-padding contract) and crop back."""
        return self.dispatch(x).fetch()

    def _check_platform(self):
        """Refuse up front to serve on a device the artifact was not exported
        for (an ``allow_custom_calls`` artifact is for the card unless its
        platforms list 'cpu')."""
        plats = self.manifest.get("platforms") or []
        if plats and self.device.type not in plats:
            raise ValueError(
                f"artifact was exported for platform(s) {plats}; this process serves on "
                f"'{self.device.type}'. Serve it on a matching device, or re-export with "
                f"platforms including '{self.device.type}' (the portable default, or "
                "allow_custom_calls with platforms=('cpu', 'cuda')).")

    def dispatch(self, x):
        """Like ``__call__`` but without fetching: pads, enqueues the program
        and returns a handle whose ``.fetch()`` yields the cropped numpy
        result. On the card the result's copy to the host is queued behind the
        replay, so a serving loop that dispatches frame i+1 before fetching
        frame i overlaps the device's work with the host's decode and encode
        (`scripts/export_model.py run`)."""
        self._check_platform()
        x = self._to_io(x)
        b, h, w, _ = x.shape
        if b != self.manifest["batch"]:
            raise ValueError(f"batch {b} != exported batch {self.manifest['batch']}")
        H, W = self._shape_for(h, w)
        if (h, w) != (H, W):
            x = _reflect_pad(x, H, W)
        return _Pending(*self.runners[(H, W)].launch(x), h, w)

    def tiled(self, x):
        """Enhance ``(1, h, w, C)`` of any size through the fixed-shape tile
        program (requires ``tile=...`` at export). Prefer whole-frame programs
        up to 4K: SS2D's receptive field is frame-global, so tiles trade
        fidelity for unbounded size."""
        if "tile" not in self.runners:
            raise ValueError("artifact was exported without a tile program")
        self._check_platform()
        t = self.manifest["tile"]
        run = self.runners["tile"]
        geometry = {"tile_size": t["size"], "tile_pad": t["pad"], "pad_multiple": t["pad_multiple"],
                    "tile_batch": t["batch"]}
        if self.manifest.get("mesh_devices", 1) > 1:
            return tiled_apply_mesh(_Runner.run, run, self._to_io(x), self._group_mesh(),
                                    device=self.device, **geometry)
        return tiled_apply(lambda chunk: _Pending(*run.launch(chunk)).fetch(), self._to_io(x),
                           **geometry)

    def _group_mesh(self):
        """The mesh of the process group that a sharded tile program serves
        under: as many ranks as the artifact's `mesh_devices`, or an error
        (one process never serves it alone)."""
        import torch.distributed as dist

        from wavemamba_torch.parallel.mesh import axis_size, make_mesh

        n = self.manifest["mesh_devices"]
        if self._mesh is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(f"tile program was exported for {n} devices; this process is in "
                                 f"no process group: serve it from {n} ranks (torchrun "
                                 f"--nproc_per_node={n}, or parallel.initialize)")
            self._mesh = make_mesh()
        if axis_size(self._mesh) != n:
            raise ValueError(f"tile program was exported for {n} devices; the process group has "
                             f"{axis_size(self._mesh)} rank(s)")
        return self._mesh


class _Pending:
    """Handle for a dispatched but unfetched program call: the output tensor
    (on the host), the event after its copy (None on the CPU), and the size to
    crop to (None: the whole output)."""

    def __init__(self, y, done, h=None, w=None):
        self._y, self._done, self._h, self._w = y, done, h, w

    def fetch(self):
        if self._done is not None:
            self._done.synchronize()
        return self._y.numpy()[:, : self._h, : self._w]


def _reflect_pad(x, H, W):
    """Bottom/right reflect pad, re-reflecting when the pad exceeds the
    extent (as `models.wavemamba.pad_to_multiple`)."""
    return np.pad(x, ((0, 0), (0, H - x.shape[1]), (0, W - x.shape[2]), (0, 0)), mode="reflect")


def load_exported(path, compile_cache=None, device="cuda"):
    return ExportedModel.load(path, compile_cache=compile_cache, device=device)
