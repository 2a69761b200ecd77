"""CUDA-graph stages: one stage function at one bucket key, captured once
and replayed.

Counterparts: the JAX engine's per-bucket executables,
``lighthouse_tpu/ops/bm/backend.py`` (``_stage1_jit``, ``_stage3_jit``,
``_prepare_jit``, ``jitted_core``) and ``lighthouse_tpu/ops/kzg.py``
(``_jitted``). A jit compiles its function once per shape; a
``StaticGraph`` captures its function once per bucket key, so that a warm
call is a copy of the staged batch into static input tensors and one graph
replay, with none of the stage's ~3k-8k kernel launches dispatched from
Python.

A StaticGraph owns static inputs of its key's shapes. A call copies each
argument into its static input (every position, padding included, so a
smaller batch leaves nothing of a larger one), then:

- on CUDA, the first call runs the function once eagerly on a side stream
  (which builds the kernel libraries and makes the cached device constants,
  none of which may happen under capture), captures it with
  ``torch.cuda.graph`` and instantiates the graph; every call replays it.
  The outputs are the graph's static outputs, overwritten by the next call
  of any graph that shares its lock. A failed capture or replay raises:
  nothing falls back to the eager function;
- on the CPU, which a caller must ask for, the function runs on the static
  inputs, uncaptured, and its results become the outputs.

Threads and streams: every call holds the graph's lock (a ``GraphLock``,
shared by graphs whose buffers a chain passes between them: ``key_lock``).
A caller holds it until it has queued its reads of the outputs. The lock
also orders the device work of its holders: a call first makes its stream
wait for the event that ends the last work queued under the lock (its
``tail``), and records a new tail after its replay; a caller that queues
reads of the outputs after that records the tail again (``mark``). So a
holder on another stream (the warmer's) never overwrites the static
inputs, the outputs or the shared pool while earlier work still uses them,
and a caller may let go of the lock before the device has run its graphs
(the async verify). No one waits on the host for it. Static inputs are
allocated uninitialised (every call overwrites them), so no fill kernel
races on another stream. One warm-up and capture runs at a time in the
process (``_CAPTURE``), and each thread captures on a stream of its own in
``thread_local`` mode, so a thread may replay while another captures.
"""

import ctypes
import functools
import threading
import time

import torch

from . import fused

_CAPTURE = threading.Lock()
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()
_LOCAL = threading.local()
_LIBCUDA = []


class GraphLock:
    """A reentrant lock over a set of graphs, and the CUDA event that ends
    the last device work queued under it (module docstring)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tail = None       # (event, stream) of the last work queued

    def __enter__(self) -> "GraphLock":
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def follow(self, stream) -> None:
        """Queue on `stream` a wait for the last work under the lock (held)."""
        if self._tail is not None and self._tail[1] != stream:
            stream.wait_event(self._tail[0])

    def mark(self, stream) -> None:
        """Record on `stream` the end of the work queued so far (held)."""
        event = torch.cuda.Event()
        event.record(stream)
        self._tail = (event, stream)


def key_lock(key) -> GraphLock:
    """The one lock of `key` in this process."""
    with _LOCKS_GUARD:
        lock = _LOCKS.get(key)
        if lock is None:
            lock = _LOCKS[key] = GraphLock()
        return lock


def _indexed(arg):
    """A CUDA device without an index -> the current one's (cuda -> cuda:0),
    as the staged tensors name it; any other argument as it is."""
    if isinstance(arg, torch.device) and arg.type == "cuda" and arg.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return arg


def cached(build):
    """functools.lru_cache for graph builders, safe across threads: the
    first caller of a key builds it under that key's lock, and a caller of
    the same key meanwhile waits and gets the same object. A torch.device
    in the key counts with its index, so cuda and cuda:0 are one key."""
    memo: dict = {}

    @functools.wraps(build)
    def get(*key):
        key = tuple(_indexed(arg) for arg in key)
        try:
            return memo[key]
        except KeyError:
            pass
        with key_lock((build.__module__, build.__qualname__) + key):
            if key not in memo:
                memo[key] = build(*key)
            return memo[key]

    get.cache = memo
    return get


@cached
def pool(name: str, key, device):
    """A CUDA graph memory pool for the graphs that `name` and `key` name
    (None on the CPU). Graphs share a pool only where their callers never
    run them at the same time and read no graph's outputs after another
    graph of the pool has replayed."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def _capture_stream(device) -> torch.cuda.Stream:
    streams = getattr(_LOCAL, "streams", None)
    if streams is None:
        streams = _LOCAL.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def rss_bytes() -> int:
    """This process's resident host memory (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with keep_graph=True
    (cuGraphGetNodes on its cudaGraph_t)."""
    if not _LIBCUDA:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        _LIBCUDA.append(lib)
    count = ctypes.c_size_t(0)
    rc = _LIBCUDA[0].cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return count.value


class StaticGraph:
    """`fn` at one key: static inputs of `specs` ((shape, dtype) each) on
    `device`, captured on the first CUDA call and replayed after it (module
    docstring). `stats` holds the capture's costs once there was one:
    warm-up, capture and instantiation seconds, node count, the wrappers'
    launches during the capture (exact while no other thread launches
    kernels eagerly), host RSS and pool bytes (memory_reserved) it added."""

    def __init__(self, fn, specs, device, name: str, lock=None, pool=None):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.inputs = tuple(torch.empty(shape, dtype=dtype, device=self.device)
                            for shape, dtype in specs)
        self.lock = GraphLock() if lock is None else lock
        self.pool = pool
        self.graph = None
        self.outputs = None
        self.stats = None
        self.calls = 0

    def __call__(self, *args):
        if len(args) != len(self.inputs):
            raise TypeError(f"{self.name}: {len(args)} arguments for {len(self.inputs)} inputs")
        for i, (src, dst) in enumerate(zip(args, self.inputs)):
            if not isinstance(src, torch.Tensor) or (src.shape, src.dtype, src.device) != (
                    dst.shape, dst.dtype, dst.device):
                got = (tuple(src.shape), src.dtype, src.device) if isinstance(src, torch.Tensor) \
                    else type(src).__name__
                raise ValueError(f"{self.name}: input {i} is {got}, the static input is "
                                 f"{(tuple(dst.shape), dst.dtype, dst.device)}")
        with self.lock:
            stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
            if stream is not None:
                self.lock.follow(stream)
            for src, dst in zip(args, self.inputs):
                dst.copy_(src)
            self.calls += 1
            if stream is None:
                self.outputs = self.fn(*self.inputs)
                return self.outputs
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.lock.mark(stream)
            return self.outputs

    def _capture(self) -> None:
        stream = _capture_stream(self.device)
        with _CAPTURE:
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self.fn(*self.inputs)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = sum(fused.launches.values())
            rss0 = rss_bytes()
            reserved0 = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t1 = time.perf_counter()
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*self.inputs)
            t2 = time.perf_counter()
            graph.instantiate()
            t3 = time.perf_counter()
            launched = sum(fused.launches.values()) - before
            self.stats = {"warmup_s": t1 - t0, "capture_s": t2 - t1, "instantiate_s": t3 - t2,
                          "nodes": graph_nodes(graph), "launches": launched,
                          "rss_bytes": rss_bytes() - rss0,
                          "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved0}
            self.graph, self.outputs = graph, outputs
