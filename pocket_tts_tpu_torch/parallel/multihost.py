"""Process-group bring-up and the mesh heartbeat.
Port of pocket_tts_tpu/parallel/multihost.py.

The JAX package runs one process per host and lets `jax.devices()` span the
job. The port runs one process per device: `initialize_multihost` joins this
process to a `torch.distributed` group (NCCL for a card, gloo for the CPU)
from explicit arguments or from the environment (`MASTER_ADDR`,
`MASTER_PORT`, `RANK`, `WORLD_SIZE`), and pins the process to its card.
With neither, it makes a group of one on a free localhost port: collectives
need a group even where the JAX package's call is a no-op.

`ControlPlane` carries a sharded server's ops (api/server.py) beside the data
plane: gloo groups of CPU tensors whose waits end in an exception after a
timeout of their own, where a collective on the default group waits for
INIT_TIMEOUT_S and, on NCCL, its watchdog then tears the process down; and
the followers' heartbeats, on which rank 0 aborts the mesh's NCCL
communicators (`abort_mesh`) when a follower is lost.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import threading
import time

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

INIT_TIMEOUT_S = 600.0  # how long a process waits for its peers to join
HEALTH_TIMEOUT_S = 10.0  # how long a control-plane wait or the heartbeat may take
IDLE_TIMEOUT_S = 30 * 24 * 3600.0  # how long a follower waits for rank 0
BEAT_S = 1.0  # a follower's heartbeat period


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Join (or make) this process's group. `coordinator_address`: host:port
    of process 0; `device`: the card by default (cuda:{rank % device count},
    NCCL), "cpu" for gloo. A group that already exists is kept. Returns the
    JAX package's summary dict, one device per process."""
    if not dist.is_initialized():
        env = os.environ
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
        if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = num_processes or 1
        if world > 1 and (coordinator_address is None or process_id is None):
            raise ValueError(f"a job of {world} processes needs the coordinator's "
                             "address and this process's id")
        rank = process_id or 0
        coordinator_address = coordinator_address or f"127.0.0.1:{_free_port()}"
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            if not torch.cuda.is_available():
                raise RuntimeError("No CUDA device found; pass device='cpu' for gloo on the CPU")
            index = torch.device(device).index if device is not None else None
            torch.cuda.set_device(rank % torch.cuda.device_count() if index is None else index)
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
    logger.info("multihost: %s", info)
    return info


def group_device() -> torch.device:
    """The device the default group's collectives take tensors on."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def assert_mesh_healthy(mesh, timeout: float | None = None) -> bool:
    """Liveness collective over the mesh: every rank contributes 1, summed
    over each of the mesh's dims in turn; the total must equal the mesh's
    size. A rank that is gone makes the collective fail or time out. With
    `timeout` (seconds) each all-reduce is waited for that long at most, and
    a failed or timed-out one returns False; without it, a failure raises
    and a wait lasts the group's timeout."""
    ones = torch.ones((1,), dtype=torch.int32, device=group_device())
    for name in mesh.mesh_dim_names:
        if timeout is None:
            dist.all_reduce(ones, group=mesh.get_group(name))
            continue
        try:
            work = dist.all_reduce(ones, group=mesh.get_group(name), async_op=True)
            work.wait(timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError as e:  # gloo and NCCL raise their faults as RuntimeError
            logger.warning("mesh heartbeat over %r failed: %s", name, e)
            return False
    return int(ones.item()) == mesh.size()


def abort_mesh(mesh) -> int:
    """Abort the NCCL communicators of the mesh's groups and of the default
    group, so that a collective waiting on a lost process ends (its kernel
    exits; any later collective on them raises) and the NCCL watchdog has no
    wait left to time out on. The groups are aborted at once, each from a
    thread of its own (NCCL may not finish aborting one communicator while
    a kernel of another on the same device still waits), each waited for
    HEALTH_TIMEOUT_S at most. gloo groups are left as they are: a lost
    peer's closed sockets end their waits. Returns the groups whose abort
    returned in time."""
    groups = {id(g): g for g in [*(mesh.get_group(n) for n in mesh.mesh_dim_names),
                                 dist.group.WORLD]}
    threads = [threading.Thread(target=g.abort, name="nccl-abort", daemon=True)
               for g in groups.values() if dist.get_backend(g) == "nccl"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HEALTH_TIMEOUT_S)
    return sum(not t.is_alive() for t in threads)


class ControlPlaneError(RuntimeError):
    """A control-plane collective failed or timed out: a process of the job
    is gone or stuck, and the groups are not used again."""


class ControlPlane:
    """Rank 0's ops to every other process of the job, the agreements that
    keep them in step (api/server.py's sharded server), and the followers'
    heartbeats.

    Two gloo groups of CPU tensors, made beside the default group (so every
    process must construct the plane, in the same order as its other
    groups):
    * `ops`: the op header, which rank 0 broadcasts and a follower waits for
      while idle (IDLE_TIMEOUT_S on a follower: it may wait long for the
      next request; a process that dies closes its sockets, which ends the
      wait at once; `health_timeout` on rank 0, as on `ctl`);
    * `ctl`: everything else: the op's payload, the agreements, the health
      count. Rank 0 waits `health_timeout` at most (the module's
      HEALTH_TIMEOUT_S when the plane is made), so a follower that is gone
      or stuck makes rank 0's next wait raise on rank 0's own thread
      instead of hanging. A follower waits for rank 0 as long as rank 0
      takes (IDLE_TIMEOUT_S; a gloo group's timeout is each process's own):
      rank 0 may reach an agreement long after it, held by a client that
      reads slowly. The other way round, a follower may reach an agreement
      long after rank 0 (a data-parallel rank decodes its own stream, and
      a loaded host slows one process more than another), so rank 0 enters
      an agreement's all-reduce only once every follower has arrived at it
      (`agree`: a counter of arrivals per follower in the job's store),
      waiting as long as their heartbeats move.
    Heartbeats: each follower adds one to a counter of its own in the job's
    store every BEAT_S; `watch` (rank 0) reports a follower whose counter
    has stood still for `health_timeout`. That is the one sign of a lost
    follower while rank 0 waits in a collective of the data plane, which on
    NCCL does not end by itself.
    An op is (name, meta, blob): a JSON-able dict and raw bytes; one with
    neither (stop, health) is its header alone. A gloo send ends only when
    its peer receives, so a follower that is alive but not receiving
    (stuck, or stopped) holds rank 0's send until the group's timeout ends
    it in gloo itself: that is why every group of rank 0 has the health
    timeout. A send that only a caller's wait gave up on would stay pending
    and keep rank 0's process from exiting (gloo joins its worker threads
    at exit). `stop` also sends only to followers that still beat
    (`followers_beat`)."""

    OPS = ("stop", "health", "tts")

    def __init__(self):
        self.health_timeout = HEALTH_TIMEOUT_S
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        wait_s = self.health_timeout if self.rank == 0 else IDLE_TIMEOUT_S
        self.ops = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=wait_s))
        self.ctl = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=wait_s))
        self._store = dist.distributed_c10d._get_default_store()
        self._agreements = 0  # agreements this process has entered
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        if self.rank:
            self._start(self._beat, "control-plane-beat")

    def _start(self, target, name: str) -> None:
        self._thread = threading.Thread(target=target, name=name, daemon=True)
        self._thread.start()

    def _beat_key(self, rank: int) -> str:
        return f"control-plane/{self.ctl.group_name}/beat/{rank}"

    def _arrival_key(self, rank: int) -> str:
        return f"control-plane/{self.ctl.group_name}/arrived/{rank}"

    def _beat(self) -> None:
        key = self._beat_key(self.rank)
        while True:
            try:
                self._store.add(key, 1)
            except Exception:  # noqa: BLE001 — rank 0 (the store's host) is gone
                return
            if self._closed.wait(BEAT_S):
                return

    def watch(self, on_lost) -> None:
        """Rank 0: call `on_lost(message)` once, from a thread of its own,
        when a follower's heartbeat has not moved for `health_timeout`
        seconds (the process is gone, or its host is stuck). Ends with
        `close`."""
        def run():
            seen = {r: (-1, time.monotonic()) for r in range(1, self.size)}
            while not self._closed.wait(BEAT_S):
                for r, (count, since) in seen.items():
                    now = time.monotonic()
                    try:
                        beats = self._store.add(self._beat_key(r), 0)
                    except Exception as e:  # noqa: BLE001 — the store is this process's
                        on_lost(f"heartbeat of process {r} unreadable: {e}")
                        return
                    if beats != count:
                        seen[r] = (beats, now)
                    elif now - since > self.health_timeout:
                        on_lost(f"process {r} sent no heartbeat for {now - since:.1f} s")
                        return

        if self.size > 1:
            self._start(run, "control-plane-watch")

    def followers_beat(self, timeout: float) -> bool:
        """Rank 0: whether every follower's heartbeat moves within `timeout`
        seconds (a live follower beats every BEAT_S)."""
        try:
            seen = {r: self._store.add(self._beat_key(r), 0) for r in range(1, self.size)}
            deadline = time.monotonic() + timeout
            while seen:
                seen = {r: n for r, n in seen.items()
                        if self._store.add(self._beat_key(r), 0) == n}
                if seen and time.monotonic() > deadline:
                    return False
                if seen:
                    time.sleep(BEAT_S / 10)
        except Exception:  # noqa: BLE001 — the store is this process's own: gone, not alive
            return False
        return True

    def close(self) -> None:
        """End this process's heartbeat or watch, and wait for its thread
        (a thread left inside a store call at exit aborts the process)."""
        self._closed.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5 * BEAT_S)

    def _call(self, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except RuntimeError as e:
            raise ControlPlaneError(f"control plane: {e}") from e

    def send(self, op: str, meta: dict | None = None, blob: bytes = b"") -> None:
        """Rank 0: broadcast one op to every follower: the header on `ops`,
        the payload on `ctl`, each ended by gloo after `health_timeout`."""
        text = json.dumps(meta).encode() if meta else b""
        header = torch.tensor([self.OPS.index(op), len(text), len(blob)], dtype=torch.int64)
        self._call(dist.broadcast, header, src=0, group=self.ops)
        payload = text + blob
        if payload:
            self._call(dist.broadcast, torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                       src=0, group=self.ctl)

    def receive(self) -> tuple[str, dict, bytes]:
        """A follower: wait for rank 0's next op."""
        header = torch.zeros(3, dtype=torch.int64)
        self._call(dist.broadcast, header, src=0, group=self.ops)
        op, n_meta, n_blob = (int(v) for v in header)
        payload = torch.empty(n_meta + n_blob, dtype=torch.uint8)
        if n_meta + n_blob:
            self._call(dist.broadcast, payload, src=0, group=self.ctl)
        data = payload.numpy().tobytes()
        return self.OPS[op], json.loads(data[:n_meta]) if n_meta else {}, data[n_meta:]

    def agree(self, *flags: bool) -> list[bool]:
        """Each flag, set where any process set it (every process calls, in
        the same order). A follower marks its arrival first; rank 0 waits
        for every follower's (`_await_arrivals`) before the all-reduce, so
        a follower that is slower but alive is waited for."""
        self._agreements += 1
        if self.rank:
            self._call(self._store.add, self._arrival_key(self.rank), 1)
        else:
            self._await_arrivals(self._agreements)
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        self._call(dist.all_reduce, t, op=dist.ReduceOp.MAX, group=self.ctl)
        return [bool(v) for v in t]

    def _await_arrivals(self, n: int) -> None:
        """Rank 0: wait until every follower has arrived at its `n`th
        agreement, as long as each one still missing beats; raises
        ControlPlaneError when one's heartbeat stands still for
        `health_timeout` (gone or its host stuck) or the plane is closed."""
        seen: dict[int, tuple[int, float]] = {}
        while True:
            missing = [r for r in range(1, self.size)
                       if self._call(self._store.add, self._arrival_key(r), 0) < n]
            if not missing:
                return
            now = time.monotonic()
            for r in missing:
                beats = self._call(self._store.add, self._beat_key(r), 0)
                if r not in seen or seen[r][0] != beats:
                    seen[r] = (beats, now)
                elif now - seen[r][1] > self.health_timeout:
                    raise ControlPlaneError(f"process {r} sent no heartbeat for "
                                            f"{now - seen[r][1]:.1f} s before an agreement")
            if self._closed.wait(BEAT_S / 10):
                raise ControlPlaneError("the control plane closed before an agreement")

    def count(self) -> int:
        """The processes that answer: every process contributes 1."""
        t = torch.ones(1, dtype=torch.int32)
        self._call(dist.all_reduce, t, group=self.ctl)
        return int(t)
