"""Checkpoint / resume for renderer state — port of
sunray_tpu/utils/checkpoint.py.

The whole cross-frame state (accumulation image, DI/GI reservoirs, frame
counter, previous view-proj) is one RenderState, so progressive renders
and training runs resume exactly. A checkpoint is an npz file whose
`leaf_{i}` arrays are the state's tensors in dataclass field order,
depth first: the order of JAX's tree_flatten of the JAX package's
RenderState (flax struct.dataclass field order), whose fields and
reservoir fields this package keeps in the same order. So a file written
by either package loads into the other (tests/test_torch_utils.py).

The JAX package's orbax path is JAX-only; the npz files here are its
fallback's. AsyncCheckpointManager writes them on one background thread
after taking a host copy of the state, and wait() returns only once every
file is written and synced to disk.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch


def _leaves(x):
    """The tensors of a (nested) dataclass in field order, depth first."""
    if torch.is_tensor(x):
        return [x]
    return [leaf for f in dataclasses.fields(x)
            for leaf in _leaves(getattr(x, f.name))]


def _rebuild(template, leaves):
    """template's structure with its tensors taken in turn from `leaves`."""
    if torch.is_tensor(template):
        return next(leaves)
    return type(template)(**{f.name: _rebuild(getattr(template, f.name),
                                              leaves)
                             for f in dataclasses.fields(template)})


def _host_arrays(state):
    """A host copy of every leaf (a copy also of a CPU tensor)."""
    return {f"leaf_{i}": x.detach().to("cpu", copy=True).numpy()
            for i, x in enumerate(_leaves(state))}


def _write(arrays, path):
    """np.savez_compressed to path (".npz" appended if missing, as numpy
    does), through a temporary file that is synced and then renamed."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_state(state, path: str) -> None:
    _write(_host_arrays(state), path)


def load_state(path: str, template):
    """Load into the structure of `template` (shapes must match), each
    tensor on its template tensor's device and in its dtype."""
    with np.load(path) as data:
        leaves = []
        for i, t in enumerate(_leaves(template)):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                                 f"{tuple(t.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=t.device,
                                                   dtype=t.dtype))
    return _rebuild(template, iter(leaves))


class AsyncCheckpointManager:
    """Non-blocking step checkpoints for progressive renders and training
    loops: `save(step, state)` returns once the state is copied to the
    host, and the file is written on a background thread, overlapping the
    next frames' compute. The API is the JAX package's.

    Typical loop:
        mgr = AsyncCheckpointManager(dir, max_to_keep=3)
        for step in range(n):
            state, img, _ = render_frame(scene, cfg, state, mats)
            if step % 64 == 0:
                mgr.save(step, state)
        mgr.wait(); mgr.close()
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        # One worker: files are written, and old ones removed, in order.
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []

    def _npz_path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step:012d}.npz")

    def _npz_steps(self):
        return sorted(int(f[len("state_"):-len(".npz")])
                      for f in os.listdir(self.directory)
                      if f.startswith("state_") and f.endswith(".npz"))

    def _commit(self, step, arrays):
        _write(arrays, self._npz_path(step))
        steps = self._npz_steps()
        for s in steps[: max(0, len(steps) - self._max_to_keep)]:
            os.remove(self._npz_path(s))

    def save(self, step: int, state) -> None:
        arrays = _host_arrays(state)     # the snapshot: later frames may
        self._pending.append(            # overwrite the device tensors
            self._pool.submit(self._commit, step, arrays))

    def latest_step(self):
        self.wait()
        steps = self._npz_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int = None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        self.wait()
        return load_state(self._npz_path(step), template)

    def wait(self) -> None:
        """Block until every save is written and synced; re-raise the
        first failure of one."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
