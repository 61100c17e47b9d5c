"""Production mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``.  Single pod: (16, 16) over ("data",
"model") — 256 devices.  Multi-pod: (2, 16, 16) over ("pod", "data",
"model") — 512 devices.

Nothing here runs at import.  A mesh is built on the default process
group, which ``process_group`` makes and destroys: one rank of NCCL on
the card or of gloo on the host (``host_group``), several gloo ranks
meeting through a file, or torch's fake group for the dry run
(``fake_group``), whose collectives move nothing, so a 512-device
program traces on one host.  The store is in memory (``HashStore``) or
in a file (``FileStore``), never TCP.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0, *,
                  store_path: Optional[str] = None):
    """The default process group while entered.  ``backend`` is "nccl",
    "gloo" or "fake"; ranks meet through a ``FileStore`` at
    ``store_path`` when there are several (else a ``HashStore`` in
    memory)."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    if backend == "fake":
        store = _fake_store()
    elif store_path is not None:
        store = dist.FileStore(store_path, world_size)
    elif world_size == 1:
        store = dist.HashStore()
    else:
        raise ValueError(f"{world_size} ranks need a store_path")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group"
            " (torch.testing._internal.distributed.fake_pg), which this"
            " torch build lacks") from e
    return FakeStore()


def fake_group(world_size: int):
    """A fake default group of ``world_size`` ranks (this process is rank
    0): collectives are accepted and move nothing."""
    return process_group("fake", world_size)


def host_group(device="cuda"):
    """A one-rank default group: NCCL for "cuda" (raising without a
    card), gloo for "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for a"
                           " host mesh on the CPU")
    return process_group("nccl" if dev.type == "cuda" else "gloo", 1)


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a mesh is on the card"
                           " by default; pass device_type='cpu' for one on"
                           " the host")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: build the mesh inside"
                           " launch.mesh.process_group (or fake_group /"
                           " host_group)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the default"
                           f" group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh on the default group, on the card
    unless ``device_type`` says otherwise (the dry run makes that group
    the fake one, asks for "cpu" and puts its tensors on "meta", so
    nothing runs on the mesh's device)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _mesh(device_type, shape, axes)


def make_mesh(shape: Tuple[int, ...], device_type: str = "cuda"):
    """A mesh of ``shape`` over ("data", "model") or ("pod", "data",
    "model") on the default group, on the card unless ``device_type``
    says otherwise (tests: (2, 2), (2, 2, 2) on "cpu")."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return _mesh(device_type, tuple(shape), axes)


def make_host_mesh(device="cuda"):
    """A (1, 1) mesh over ("data", "model") on a one-rank default group
    (``host_group``): the card's under NCCL, or the CPU's under gloo when
    the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for a"
                           " host mesh on the CPU")
    if dist.is_initialized():
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(f"a {dev.type} host mesh needs a {want}"
                               f" group, not {dist.get_backend()}")
    return _mesh(dev.type, (1, 1), ("data", "model"))

