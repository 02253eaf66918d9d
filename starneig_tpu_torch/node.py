"""Execution-environment ("node") layer of the PyTorch port.

Counterpart of ``starneig_tpu/node.py`` (reference ``src/common/node.c``,
public API ``starneig/node.h:178-241``).  What is node-level state here:

  * this process's rank, the world size and the process group
    (``torch.distributed``), one process a rank;
  * the rank's device: ``cuda:{rank % device_count}`` unless the caller
    asks for the CPU;
  * the message verbosity flags (reference: node.h:141-152).

``node_init``/``node_finalize`` keep the reference's bracketed lifecycle;
calling a function without an explicit init is allowed (a one-process
node is created lazily).  The process group's backend is ``gloo`` when the
ranks run on the CPU or share a card (NCCL refuses two ranks on one GPU),
``nccl`` when each rank has a card of its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("starneig_tpu_torch")

# Init flags (reference: node.h:84-152). The hints are accepted for parity
# and select nothing; the NO_* flags set the logger's level.
DEFAULT = 0
HINT_SM = 1 << 0
HINT_DM = 1 << 1
NO_VERBOSE = 1 << 4
NO_MESSAGES = 1 << 5


@dataclasses.dataclass
class Node:
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]       # None: no process group (a world of one)
    flags: int
    owns_group: bool             # node_finalize destroys the group

    @property
    def n_devices(self) -> int:
        return self.world_size


_NODE: Optional[Node] = None


def rank_device(device, rank: int = 0) -> torch.device:
    """The device a rank runs on: ``device`` if given, else the card
    ``cuda:{rank % device_count}``.  Raises ``RuntimeError`` if that is a
    CUDA device and there is no card: nothing falls back to the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} asked for and no CUDA card is available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "starneig_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def node_init(init_method: Optional[str] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              backend: Optional[str] = None, device=None,
              flags: int = DEFAULT, timeout_s: float = 600.0) -> Node:
    """Initialize the execution environment (reference: node.h:178).

    Args:
      init_method: the process group's rendezvous (``file://...``,
        ``tcp://host:port``; ``env://`` when only ``world_size`` is given).
        With neither it nor ``world_size`` the node is a world of one.
      world_size, rank: the group's size and this process's rank.
      backend: ``gloo`` or ``nccl``; by default gloo when the ranks run on
        the CPU or share a card, nccl when each has a card of its own.
      device: this rank's device; default ``cuda:{rank % device_count}``,
        and ``RuntimeError`` without a card.
      flags: bitwise OR of init flags (``HINT_SM``/``HINT_DM``/``NO_*``).
      timeout_s: the process group's timeout for rendezvous and each
        collective.

    Idempotent: with a process group already up (an earlier call, or the
    caller's own ``init_process_group``) it joins that group.
    """
    global _NODE
    owns = _NODE.owns_group if _NODE is not None else False
    if dist.is_initialized():
        size, r = dist.get_world_size(), dist.get_rank()
        dev = rank_device(device, r)
        backend = dist.get_backend()
    elif init_method is not None or world_size is not None:
        r = int(rank if rank is not None else 0)
        size = int(world_size) if world_size is not None else None
        dev = rank_device(device, r)
        if backend is None:
            shared = size is None or dev.type != "cuda" \
                or size > torch.cuda.device_count()
            backend = "gloo" if shared else "nccl"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=size, rank=r,
            timeout=datetime.timedelta(seconds=timeout_s))
        size = dist.get_world_size()
        owns = True
    else:
        size, r, backend = 1, 0, None
        dev = rank_device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if flags & NO_MESSAGES:
        log.setLevel(logging.ERROR)
    elif flags & NO_VERBOSE:
        log.setLevel(logging.INFO)
    else:
        log.setLevel(logging.DEBUG)
    _NODE = Node(rank=r, world_size=size, device=dev, backend=backend,
                 flags=flags, owns_group=owns)
    log.info("node_init: rank %d of %d on %s, backend %s", r, size, dev,
             backend)
    return _NODE


def node_finalize() -> None:
    """Tear down the execution environment (reference: node.h:220): the
    process group too, if ``node_init`` created it."""
    global _NODE
    if _NODE is not None and _NODE.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _NODE = None


def node_initialized() -> bool:
    return _NODE is not None


def get_node() -> Node:
    """Current node; creates a default one lazily."""
    if _NODE is None:
        node_init()
    return _NODE


def default_mesh(n_devices: Optional[int] = None):
    """The mesh of the node's ranks (DM calls default to this)."""
    from starneig_tpu_torch.parallel.distr import make_mesh
    get_node()
    return make_mesh(n_devices)
