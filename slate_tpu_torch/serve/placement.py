"""Placement policy of the serve tier: replica lanes over a device pool
(the JAX package's ``serve/placement.py`` without the sharded tier).

The policy answers which replica takes a request
(:meth:`PlacementPolicy.select_replica`): least-loaded (queue depth +
in-flight) with round-robin tie breaking, or plain round-robin; replicas
whose breaker for the bucket is cooling down, or that are quarantined
by the integrity plane, are excluded while a healthy one exists.

``devices`` defaults to ``[cuda:0]``; a CPU device is used only when the
caller passes it, and a policy with no CUDA device and no explicit
device raises.  Replica ``i`` pins its dispatches to ``devices[i %
len(devices)]``: on one H100 every lane pins ``cuda:0``.  A mesh raises
(sharded serving needs the distributed drivers, ROADMAP.md Queue 1 item
8b2), and :meth:`mesh_for` is always ``""``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..enums import Option
from ..exceptions import DistributedException
from ..options import Options, get_option
from .buckets import DEFAULT_SHARD_THRESHOLD, check_mesh

#: replica-selection strategies
LEAST_LOADED = "least_loaded"
ROUND_ROBIN = "round_robin"


class PlacementPolicy:
    """Replica lanes pinned to a device pool.

    Parameters
    ----------
    replicas: replica worker count (default 1); with more replicas than
        devices the assignment wraps.
    mesh: must be ``""`` (a sharded submesh raises: item 8b2).
    shard_threshold: kept for the JAX package's signature.
    strategy: ``"least_loaded"`` (default) or ``"round_robin"``.
    devices: the device pool; default ``[cuda:0]``.
    """

    def __init__(self, replicas: int = 1, mesh: str = "",
                 shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
                 strategy: str = LEAST_LOADED, devices: Optional[Sequence] = None):
        if check_mesh(mesh):
            raise NotImplementedError(
                f"serve mesh {mesh!r}: sharded serving needs the distributed "
                "drivers (ROADMAP.md Queue 1 item 8b2)")
        if strategy not in (LEAST_LOADED, ROUND_ROBIN):
            raise ValueError(f"unknown placement strategy {strategy!r} "
                             f"({LEAST_LOADED}|{ROUND_ROBIN})")
        self.replicas = max(int(replicas), 1)
        self.mesh = ""
        self.shard_threshold = max(int(shard_threshold), 0)
        self.strategy = strategy
        self._devices = ([torch.device(d) for d in devices]
                         if devices is not None else None)
        self._rr = 0  # round-robin cursor (ties and pure round-robin)

    @staticmethod
    def from_options(opts: Optional[Options] = None, **kw) -> "PlacementPolicy":
        """The policy from the Serve* options; ``kw`` overrides fields."""
        cfg = dict(
            replicas=int(get_option(opts, Option.ServeReplicas)),
            mesh=str(get_option(opts, Option.ServeMesh) or ""),
            shard_threshold=int(get_option(opts, Option.ServeShardThreshold)),
        )
        cfg.update({k: v for k, v in kw.items() if v is not None})
        return PlacementPolicy(**cfg)

    # -- devices -------------------------------------------------------------

    def devices(self) -> List[torch.device]:
        """The device pool: the caller's, else ``[cuda:0]``."""
        if self._devices is None:
            if not torch.cuda.is_available():
                raise DistributedException(
                    "serve: no CUDA device; pass devices=[torch.device('cpu')] to "
                    "serve on the CPU")
            self._devices = [torch.device("cuda", 0)]
        return self._devices

    def device_for(self, replica: int) -> torch.device:
        """The device replica ``replica`` pins its dispatches to."""
        devs = self.devices()
        return devs[int(replica) % len(devs)]

    def replica_devices(self) -> List[torch.device]:
        """One entry per replica: what warmup and restore prime."""
        return [self.device_for(i) for i in range(self.replicas)]

    def set_replicas(self, n: int) -> int:
        """Resize the replica set (``add_replica`` / ``remove_replica``
        keep it at the live lane count).  Clamped to >= 1; returns the
        count applied."""
        self.replicas = max(int(n), 1)
        return self.replicas

    # -- routing -------------------------------------------------------------

    def mesh_for(self, routine: str, n: int, sharded: Optional[bool] = None) -> str:
        """``""``: no mesh is configured, every request is replicated."""
        return ""

    def select_replica(self, loads: Sequence[int],
                       open_breaker: Optional[Sequence[bool]] = None) -> int:
        """The replica index for one request.  ``loads`` is per-replica
        pending work (queue depth + in-flight); ``open_breaker`` flags
        replicas to exclude while any other exists (when all are flagged
        the least-loaded one takes it anyway).  Ties break round-robin."""
        n = len(loads)
        if n == 0:
            raise ValueError("no replicas to select from")
        cand = list(range(n))
        if open_breaker is not None:
            healthy = [i for i in cand if not open_breaker[i]]
            if healthy:
                cand = healthy
        if self.strategy == ROUND_ROBIN:
            pick = cand[self._rr % len(cand)]
            self._rr += 1
            return pick
        lo = min(loads[i] for i in cand)
        tied = [i for i in cand if loads[i] == lo]
        pick = tied[self._rr % len(tied)]
        self._rr += 1
        return pick
