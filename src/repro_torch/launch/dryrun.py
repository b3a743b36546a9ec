"""Multi-pod dry run: trace every (arch x shape x mesh) cell's per-rank
program, the port's counterpart of ``repro.launch.dryrun``.

Run each cell as its own process: it starts a fake process group of the
mesh's size (``torch.distributed``'s ``fake`` backend; this process is
rank 0 of 256 or 512) and keeps it until the cell ends.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k --mesh single --out build/qwen_train_single.json
  PYTHONPATH=src python -m repro_torch.launch.run_matrix --out-dir build/dryrun

A cell's step (``launch.steps.build_cell``) and this rank's blocks of its
arguments are fake tensors on ``--device`` (the card by default, ``cpu``
for the plain host path): no memory is allocated and no kernel runs.  The
step runs once under ``FlopCounterMode``, ``MemTracker`` and an op
recorder, and the cell records: the trace's wall time, the rank's memory
(its arguments, outputs and peak), flops and bytes per rank, the
collective schedule (op counts + payload + ring wire bytes) and the three
roofline terms.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.device import DEFAULT_DEVICE

# ops that move no tensor bytes: allocations whose values are never
# written, and views of what exists
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "detach", "alias", "lift_fresh",
                       "set_", "resize_", "_local_scalar_dense"})


def _leaves(tree) -> list:
    """The tensors of an argument tree: modules' parameters and buffers,
    the values of dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(tree) -> int:
    """Bytes of the tensors of ``tree``, each counted over its distinct
    elements (a broadcast view's zero-stride dims hold one)."""
    return sum(math.prod(n for n, st in zip(t.shape, t.stride()) if st)
               * t.element_size() if t.numel() else 0
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a c10d op runs on."""
    import torch.distributed as dist
    for a, v in zip(func._schema.arguments, args):
        if a.name == "process_group":
            return dist.ProcessGroup.unbox(v).size()
    if "process_group" in kwargs:
        return dist.ProcessGroup.unbox(kwargs["process_group"]).size()
    return 1


class OpRecorder(TorchDispatchMode):
    """Counts the ops a step runs, the bytes each aten op reads and writes
    (its tensor inputs and outputs, views and allocations skipped; a
    ``prim`` query such as ``x.device`` moves none), and
    records each c10d collective as ``(op, payload bytes, group size)``:
    the payload an all-to-all's input, any other op's first argument (an
    all-reduce's tensors, an all-gather's gathered outputs, a
    reduce-scatter's output shard).  ``DTensor`` ops are left to desugar
    into the local ops it counts, and the ops of ``DTensor``'s own
    sharding propagation (under a fake mode of its own) are not counted,
    as ``MemTracker`` skips them."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.collectives: list = []
        self._fake = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        self.ops += 1
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            payload = args[1] if name.startswith("alltoall") else args[0]
            self.collectives.append((name, _nbytes(payload),
                                     _group_size(func, args, kwargs)))
        elif func.namespace == "aten" and not func.is_view \
                and name not in _NO_BYTES:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _storages(tensors) -> dict:
    """``{id: (storage, bytes)}`` of the tensors' storages (a ``DTensor``'s
    local block's)."""
    from torch.distributed._tools.common_utils import get_untyped_storages
    out = {}
    for t in tensors:
        for st in get_untyped_storages(t):
            out[id(st)] = (st, st.nbytes())
    return out


def _device_total(snapshot, device) -> int:
    return sum(snap["Total"] for d, snap in snapshot.items()
               if d.type == device.type)


def trace_step(fn, args, *, device) -> dict:
    """Run ``fn(*args)`` once under ``FlopCounterMode``, ``MemTracker`` and
    an ``OpRecorder``: flops, bytes, ops and collectives, and the memory
    on ``device``'s type — the arguments' bytes, the outputs' (``alias``:
    those in the arguments' storages) and the peak, arguments included.
    With fake arguments (under a ``FakeTensorMode``) nothing runs; on
    real tensors this is one real step."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    device = torch.device(device)
    held = _leaves(args)
    mt = MemTracker()
    mt.track_external(*held)
    arg_bytes = _device_total(mt.get_tracker_snapshot("current"), device)
    rec = OpRecorder()
    fc = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with fc, mt, rec:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    peak = _device_total(mt.get_tracker_snapshot("peak"), device)
    ins = _storages(held)
    outs = _storages(_leaves(out))
    out_bytes = sum(b for _, b in outs.values())
    alias = sum(b for k, (_, b) in outs.items() if k in ins)
    return {"flops": int(fc.get_total_flops()), "bytes": rec.bytes,
            "ops": rec.ops, "collectives": rec.collectives,
            "trace_s": trace_s, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "alias_bytes": alias,
            "peak_bytes": peak}


@contextlib.contextmanager
def fake_world(*, multi_pod: bool, device=DEFAULT_DEVICE):
    """The production mesh over a fake process group of its size, this
    process rank 0, installed (``set_mesh``) until exit, when the group
    is destroyed.  The data axes' flattened groups are made here, outside
    any ``FakeTensorMode`` (``core.distributed.axis_group`` reads the
    mesh's rank grid)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.core.distributed import axis_group
    from repro_torch.dist import context as dist_context
    from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
    shape, _ = PRODUCTION[multi_pod]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        dist_context.set_mesh(mesh)
        axis_group(mesh, dist_context._resolve(mesh, "dp"))
        yield mesh
    finally:
        dist_context.set_mesh(None)
        dist.destroy_process_group()


def _trace_once(cfg, shape, mesh, opt_cfg, device) -> dict:
    """Build one cell on fake tensors and trace its step under the
    installed ``mesh``; return the trace (``trace_step``'s record,
    ``trace_s`` from the cell's build on)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import steps as steps_mod

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, _, _ = steps_mod.build_cell(
            cfg, shape, mesh, opt_cfg=opt_cfg, device=device)
        rec = trace_step(fn, args, device=device)
    rec["trace_s"] = time.perf_counter() - t0
    return rec


def _analyse(trace) -> dict:
    from repro_torch.launch import roofline as rl
    coll = rl.collective_stats(trace["collectives"])
    return {"flops": trace["flops"], "bytes_accessed": trace["bytes"],
            "collectives": coll.summary(), "wire_bytes": coll.wire_bytes,
            "ops_traced": trace["ops"]}


def _memory(trace) -> dict:
    """The reference's ``memory_analysis`` keys from the traced rank:
    arguments, outputs and their alias of the arguments, and the
    temporaries as the rest of the peak, so ``hbm_per_device_bytes`` (the
    reference's arg + temp + out - alias) is the traced peak."""
    arg_b, out_b = trace["argument_bytes"], trace["output_bytes"]
    alias_b = trace["alias_bytes"]
    tmp_b = max(0, trace["peak_bytes"] - arg_b - max(0, out_b - alias_b))
    ma = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
          "temp_size_in_bytes": tmp_b, "alias_size_in_bytes": alias_b}
    return {"memory_analysis": ma,
            "hbm_per_device_bytes": arg_b + tmp_b + max(0, out_b - alias_b)}


def _depth_points(cfg) -> tuple[int, int]:
    """Two reduced depths for the cost model's traces."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return k, 2 * k
    if cfg.moe and cfg.first_dense_layers:
        return cfg.first_dense_layers + 2, cfg.first_dense_layers + 4
    return 2, 4


def _with_depth(cfg, layers: int):
    kw = {"num_layers": layers, "unroll_layers": True}
    if cfg.is_encdec:
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _exact(value: Fraction):
    return int(value) if value.denominator == 1 else float(value)


def param_counts(cfg) -> tuple[int, int, int]:
    """(total, embedding + head, routed experts) parameters of ``cfg``'s
    model on the ``meta`` device, each state-dict name read as the
    reference's leaf path (``moe_layers.3.moe.wi.w`` is
    ``moe_layers/moe/wi/w``)."""
    from repro_torch.models.model import init_params
    model = init_params(cfg, device="meta")
    total, embed, moe_expert = 0, 0, 0
    for name, leaf in model.named_parameters():
        path = "/".join(p for p in name.split(".") if not p.isdigit())
        n = int(leaf.numel())
        total += n
        if path.startswith("embed/") or path.startswith("lm_head/"):
            embed += n
        if "/moe/w" in path and "/shared" not in path:
            moe_expert += n
    return total, embed, moe_expert


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             overrides: dict | None = None,
             skip_cost_model: bool = False,
             device=DEFAULT_DEVICE) -> dict:
    """One (arch x shape x mesh) cell.

    Three traces:
      1. FULL config -> the per-rank program's flops / bytes / collectives
         (eager runs every layer, so these are exact) + its memory (the
         rank's peak);
      2/3. depth La / Lb -> per-layer flops / bytes / collective wire
         bytes, whose linear extrapolation to full depth the record keeps
         beside the full trace's counts (equal where every layer repeats).
    """
    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "overrides": overrides or {}}

    skip = steps_mod.shape_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    device = resolve_device(device)
    with fake_world(multi_pod=(mesh_kind == "multi"), device=device) as mesh:
        n_chips = math.prod(mesh.shape)
        rec["chips"] = n_chips
        opt_cfg = adamw.AdamWConfig(
            quantize_v="int8" if cfg.name.startswith("deepseek") else "none")

        # ---- 1. the full config (the dry-run deliverable) ----------------
        full = _trace_once(cfg, shape, mesh, opt_cfg, device)
        rec["trace_s"] = full["trace_s"]
        rec.update(_memory(full))
        rolled = _analyse(full)
        rec["rolled_analysis"] = {k: rolled[k] for k in
                                  ("flops", "bytes_accessed", "wire_bytes",
                                   "collectives", "ops_traced")}
        flops_dev = rolled["flops"]
        bytes_dev = rolled["bytes_accessed"]
        wire_dev = rolled["wire_bytes"]

        # ---- 2/3. depth points -> extrapolated cost ----------------------
        if not skip_cost_model:
            la, lb = _depth_points(cfg)
            pts = {}
            for L in (la, lb):
                pts[L] = _analyse(_trace_once(_with_depth(cfg, L), shape,
                                              mesh, opt_cfg, device))
            rec["depth_points"] = {str(L): {k: pts[L][k] for k in
                                            ("flops", "bytes_accessed",
                                             "wire_bytes")}
                                   for L in (la, lb)}
            # collective op counts extrapolated, per kind
            counts = {}
            for kind in set(pts[la]["collectives"]["counts"]) | \
                    set(pts[lb]["collectives"]["counts"]):
                ca_ = pts[la]["collectives"]["counts"].get(kind, 0)
                cb_ = pts[lb]["collectives"]["counts"].get(kind, 0)
                counts[kind] = _exact(ca_ + (cfg.num_layers - la) *
                                      Fraction(cb_ - ca_, lb - la))
            rec["collective_counts_extrapolated"] = counts

    rec["cost_analysis"] = {"flops": flops_dev, "bytes_accessed": bytes_dev}
    roof = rl.roofline_terms(max(0.0, flops_dev), max(0.0, bytes_dev),
                             max(0.0, wire_dev))
    rec["roofline"] = roof.as_dict()

    # ---- model flops (6ND) -------------------------------------------------
    total, embed, moe_expert = param_counts(cfg)
    nonembed = total - embed
    active = nonembed - moe_expert + (moe_expert * cfg.top_k
                                      // max(1, cfg.num_experts))
    info = steps_mod.SHAPES[shape]
    n_tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    mf = rl.model_flops(cfg, n_tokens, params_nonembed=nonembed,
                        params_active_nonembed=active)
    if info["kind"] != "train":
        mf /= 3.0                   # forward only: 2ND
    rec["params_total"] = total
    rec["params_nonembed"] = nonembed
    rec["params_active_nonembed"] = active
    rec["model_flops_global"] = mf
    hlo_flops_global = flops_dev * n_chips
    rec["useful_flops_ratio"] = (mf / hlo_flops_global
                                 if hlo_flops_global > 0 else None)
    rec["status"] = "ok"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--out")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (e.g. remat_policy=dots_saveable)")
    ap.add_argument("--skip-cost-model", action="store_true",
                    help="only the full trace (multi-pod pass)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the fake tensors live: 'cuda' (default) or "
                         "'cpu' (the plain host path)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       overrides=overrides or None,
                       skip_cost_model=args.skip_cost_model,
                       device=args.device)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "traceback": traceback.format_exc()}
    text = json.dumps(rec, indent=1, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 1 if rec.get("status") == "error" else 0


if __name__ == "__main__":
    raise SystemExit(main())
