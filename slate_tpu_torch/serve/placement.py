"""Placement policy of the serve tier in its default form: one replica
lane on one device, no mesh (the JAX package's ``serve/placement.py``
with ``replicas=1`` and no ``ServeMesh``).

``devices`` defaults to ``[cuda:0]``; a CPU device is used only when the
caller passes it, and a policy with no CUDA device and no explicit
device raises.  More than one replica raises (replica scale-out is
ROADMAP.md Queue 1 item 7), and so does a mesh (sharded serving waits
for the distributed drivers, item 8).  :meth:`mesh_for` is always
``""``: every request takes the replicated lane.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..enums import Option
from ..exceptions import DistributedException
from ..options import Options, get_option
from .buckets import DEFAULT_SHARD_THRESHOLD, check_mesh

class PlacementPolicy:
    """One replica lane pinned to ``devices[0]``."""

    def __init__(self, replicas: int = 1, mesh: str = "",
                 shard_threshold: int = DEFAULT_SHARD_THRESHOLD,
                 devices: Optional[Sequence] = None):
        if int(replicas) > 1:
            raise NotImplementedError(
                f"{replicas} serve replicas: replica scale-out is not ported yet "
                "(ROADMAP.md Queue 1 item 7)")
        if check_mesh(mesh):
            raise NotImplementedError(
                f"serve mesh {mesh!r}: sharded serving needs the distributed "
                "drivers (ROADMAP.md Queue 1 items 7 and 8)")
        self.replicas = 1
        self.mesh = ""
        self.shard_threshold = max(int(shard_threshold), 0)
        self._devices = ([torch.device(d) for d in devices]
                         if devices is not None else None)

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
        """The device the (only) lane pins its dispatches to."""
        return self.devices()[0]

    def replica_devices(self) -> List[torch.device]:
        return [self.device_for(0)]

    def mesh_for(self, routine: str, n: int, sharded: Optional[bool] = None) -> str:
        """``""``: no mesh is configured, every request is replicated."""
        return ""
