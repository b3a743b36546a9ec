"""Roofline terms of a traced dry-run cell: the port's counterpart of
``repro.launch.roofline``.

Hardware model: one NVIDIA H100 SXM per rank.

Sources (``launch.dryrun`` traces one rank's per-rank program on fake
tensors under a fake process group of the mesh's size):
  * ``FlopCounterMode``      -> flops PER RANK (matmuls, convolutions,
    attention);
  * the op recorder          -> bytes PER RANK (each aten op's inputs and
    outputs, views skipped: eager's unfused count);
  * the collectives it saw   -> ``(op, payload bytes, group size)``
    records; wire bytes modeled per ring algorithm (all-reduce 2x payload,
    reduce-scatter/all-gather 1x, all-to-all 1x), as the reference models
    the collectives of its HLO text.
"""
from __future__ import annotations

import dataclasses

# bf16 dense tensor-core FLOP/s of one H100 SXM (NVIDIA's data sheet,
# without sparsity)
PEAK_FLOPS = 989.4e12
# HBM3 bytes/s of one H100 SXM (the data sheet's 3.35 TB/s)
HBM_BW = 3.35e12
# bytes/s per rank across nodes: one 400 Gb/s NDR InfiniBand port per GPU
# (a DGX H100 node has eight, one per GPU).  A 16-rank ring of a
# production axis spans two or more 8-GPU nodes, so its slowest hop is
# this port, not the 450 GB/s NVLink inside a node
LINK_BW = 50e9

# c10d ops -> the reference's HLO collective kinds; any other op is
# counted under its own name, wired as the reference wires a permute
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    payload_bytes: dict       # per-device payload per op kind
    wire_bytes: int           # ring-model bytes crossing links, per device

    def summary(self) -> dict:
        return {"counts": self.counts, "payload_bytes": self.payload_bytes,
                "wire_bytes": self.wire_bytes}


def collective_stats(records) -> CollectiveStats:
    """The reference's ``parse_collectives`` over ``(c10d op, payload
    bytes, group size)`` records.  The payload is what the reference reads
    from an op's HLO shape: an all-reduce's tensor, an all-gather's
    gathered output, a reduce-scatter's output shard, an all-to-all's
    input."""
    counts: dict[str, int] = {}
    payload: dict[str, int] = {}
    wire = 0
    for name, size, g in records:
        op = COLLECTIVE_KINDS.get(name, name)
        counts[op] = counts.get(op, 0) + 1
        payload[op] = payload.get(op, 0) + size
        frac = (g - 1) / g if g > 1 else 0.0
        if op == "all-reduce":
            wire += int(2 * size * frac)
        elif op == "reduce-scatter":
            # the output is the scattered shard; ring wire = input*(g-1)/g
            wire += int(size * g * frac)
        elif op == "all-gather":
            wire += int(size * frac)          # output-sized payload
        else:                                  # all-to-all, the rest
            wire += int(size * frac if g > 1 else size)
    return CollectiveStats(counts, payload, wire)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "step_time_s": self.step_time_s}


def roofline_terms(flops_per_device: float, hbm_bytes: float,
                   wire_bytes: float) -> Roofline:
    return Roofline(
        flops_per_device=flops_per_device,
        hbm_bytes_per_device=hbm_bytes,
        wire_bytes_per_device=wire_bytes,
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=hbm_bytes / HBM_BW,
        collective_s=wire_bytes / LINK_BW,
    )


def model_flops(cfg, n_tokens: int, *, params_nonembed: int,
                params_active_nonembed: int | None = None) -> float:
    """MODEL_FLOPS = 6 * N * D (dense) / 6 * N_active * D (MoE)."""
    n = params_active_nonembed if params_active_nonembed is not None \
        else params_nonembed
    return 6.0 * n * n_tokens
