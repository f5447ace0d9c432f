"""Round blocks and async dispatches on the card: one fused round captured
once as a CUDA graph and replayed, the counterparts of
``repro.fed.parallel.make_sharded_block_executor`` and
``make_async_dispatch_executor``.

The reference fuses B rounds into one ``lax.scan`` dispatch with a donated
carry. Here ``GraphBlockExecutor(block_fn)`` (``block_fn`` from
``fed.rounds.make_block_executor``) captures ``block_fn.step``, one fused
round, as a ``torch.cuda.CUDAGraph`` on static carry buffers, and
``block_fn.evaluate``, the fused grouped eval, as a second graph in the
same memory pool. A block then

  1. packs the carry's host membership column and the B staged rounds
     (cohort ids, alive masks, minibatch rows) into one pinned int64
     buffer and copies it to the card in ONE host-to-device copy;
  2. for each round b: a device-to-device copy fills the round graph's
     static input from slot b, the round graph replays (it writes the new
     state back into the static carry in place), the eval graph replays
     where ``do_eval[b]`` is set, and a device-to-device copy files the
     round's metrics as row b of a (B, 5) device buffer;
  3. returns the static carry and that buffer without waiting on the card:
     the caller fetches both once, at block end.

K is static (``dropout_rate`` cohorts are padded with zero-weight lanes),
so one capture serves every block of a trainer, a partial tail block and
any eval cadence included.

Capture needs eager warm-up iterations on a side stream, and those train:
warm-up and capture run on a scratch copy of the carry (FeSEM's state
update also writes ``local_flat`` in place), and the caller's carry is
copied into the static buffers afterwards, before the first replay. The
static buffers then are the carry: the trainer points its state at them,
and a later block copies in only the tensors that changed in between.

On CPU tensors the executor runs ``block_fn`` eagerly (the plain version).
On the card it replays graphs or raises: a capture failure is raised, and
nothing runs eagerly on the card in its place.

On a data mesh (``launch.mesh.FedMesh``) the route is the mesh's backend,
chosen up front. Over NCCL the round's collectives are captured in the
graphs (one collective runs on the group first, so that its communicator
exists before the capture). Over gloo, whose collectives a graph cannot
hold, the block runs ``block_fn`` eagerly on the card, as on the CPU, and
``replays`` stays 0.

``GraphDispatchExecutor`` does the same for the async runtime
(``FedConfig.async_depth``): one dispatch is one replay of a captured
``make_async_dispatch_executor`` step, which reads the carry and writes
nothing of it. Each dispatch, on the current stream:

  1. copies the staged cohort from a pinned host buffer (one per result
     slot) to the card, and any carry tensor that does not lie in the
     graph's input buffers into them;
  2. replays the graph;
  3. copies the graph's outputs into a *result slot* of its own (a pool of
     ``depth + 1``, one taken per dispatch and given back after its fold),
     and the slot's metrics into pinned host memory, without a sync.

Stream order gives the reference's snapshot semantics: everything enqueued
before a dispatch (earlier folds, FedGroup's newcomer rows) runs before it
reads the carry, everything enqueued after it (the fold that writes the
live carry in place) after. The graph's inputs are the live carry's own
buffers: the staleness fold writes them in place, so they keep their
addresses, and a later run's carry is bound to them (``bind``): step 1
copies nothing of the carry once the graph is captured.

On a data mesh a dispatch takes the block's route: over NCCL its
all-reduces are captured in the dispatch graph (every rank replays its
dispatches in the same order, so the collectives of two dispatches in
flight on one stream pair up in stream order); over gloo the dispatch
runs eagerly on the card, ``replays`` stays 0 and the result's metrics
are host values at once.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import NamedTuple

import torch

WARMUP = 2          # eager iterations on a side stream before the capture


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic GC run first, then held off while a graph captures.
    A dropped trainer can leave its CUDAGraphs in a reference cycle; a
    collection during a capture would destroy one, which CUDA does not
    permit while a stream captures (the capture then fails in whatever
    kernel runs next), and ``torch.cuda.graph`` collects first only when
    ``torch.compiler.config.force_cudagraph_gc`` is set."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _leaves(carry: dict) -> list:
    """The carry's tensors in a fixed order (aux may be None)."""
    out = [carry["group_params"][k] for k in sorted(carry["group_params"])]
    out += [carry["global_params"][k] for k in sorted(carry["global_params"])]
    out += [carry["group_delta"]]
    if carry["aux"] is not None:
        out.append(carry["aux"])
    return out


class GraphBlockExecutor:
    """``executor(carry, train_stack, test_stack, idx, bidx, alive,
    do_eval) -> (carry, metrics)`` with ``block_fn``'s arguments and
    results (``fed.rounds.make_block_executor``): the staged idx, bidx and
    alive and the carry's membership as host tensors, do_eval as host
    bools. ``replays`` / ``eval_replays`` count the graphs' replays,
    ``captures`` the captures and ``capture_ms`` the host time of the
    one-time warm-up and capture (warm-up included). ``mesh``: the data mesh
    ``block_fn`` was built for (its backend picks the route on the card).
    """

    def __init__(self, block_fn, mesh=None):
        self.block_fn = block_fn
        self.mesh = mesh
        self.eager_on_card = mesh is not None and mesh.backend == "gloo"
        self.captures = 0
        self.replays = 0
        self.eval_replays = 0
        self.capture_ms = None
        self._graphs = None

    def __call__(self, carry, train_stack, test_stack, idx, bidx, alive,
                 do_eval):
        dev = train_stack[0].device
        if dev.type != "cuda":
            return self.block_fn(carry, train_stack, test_stack, idx, bidx,
                                 alive, do_eval)
        if self.eager_on_card:
            # gloo: the staged rounds and the membership column to the card
            idx, bidx, alive = (t.to(dev) for t in (idx, bidx, alive))
            carry = dict(carry, membership=carry["membership"].to(dev))
            return self.block_fn(carry, train_stack, test_stack, idx, bidx,
                                 alive, do_eval)
        with torch.cuda.device(dev):
            return self._replay_block(carry, train_stack, test_stack, idx,
                                      bidx, alive, do_eval)

    # -- one block -----------------------------------------------------------
    def _replay_block(self, carry, train_stack, test_stack, idx, bidx,
                      alive, do_eval):
        B, K = idx.shape
        shape = (K, tuple(bidx.shape[2:]), carry["membership"].shape[0])
        if self._graphs is None:
            self._graphs = {"shape": shape}
        g = self._graphs
        if shape != g["shape"]:
            raise ValueError(f"block of shape {shape} (K, rows, N + 1) "
                             f"differs from the captured {g['shape']}")
        n_mem, slot = shape[2], 2 * K + bidx[0].numel()
        device = train_stack[0].device
        if "metrics" not in g or B > g["metrics"].shape[0]:
            self._allocate(B, n_mem + B * slot, device)
        # the previous block's copy out of the pinned buffer has finished
        g["h2d_done"].synchronize()
        host = g["host"][:n_mem + B * slot]
        host[:n_mem].copy_(carry["membership"])
        slots = host[n_mem:].view(B, slot)
        slots[:, :K].copy_(idx)
        slots[:, K:2 * K].copy_(alive)
        slots[:, 2 * K:].copy_(bidx.reshape(B, -1))
        dev = g["dev"][:n_mem + B * slot]
        dev.copy_(host, non_blocking=True)                      # ONE H2D
        g["h2d_done"].record()
        inputs = dev[n_mem:].view(B, slot)
        if "round" not in g:
            self._capture(carry, train_stack, test_stack, inputs[0])
        static = g["carry"]
        for dst, src in zip(_leaves(static), _leaves(carry)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        static["membership"].copy_(dev[:n_mem])
        metrics = g["metrics"]
        for b in range(B):
            g["input"].copy_(inputs[b])
            g["round"].replay()
            self.replays += 1
            if do_eval[b]:
                g["eval"].replay()
                self.eval_replays += 1
            metrics[b].copy_(g["output"])
        out = dict(static)
        out["group_params"] = dict(static["group_params"])
        out["global_params"] = dict(static["global_params"])
        return out, metrics[:B]

    def _allocate(self, B, n, device):
        """The staging buffers (n int64: the membership column and up to
        B staged rounds, pinned on the host and on the card) and the (B, 5)
        metrics."""
        g = self._graphs
        g["host"] = torch.empty(n, dtype=torch.int64, pin_memory=True)
        g["dev"] = torch.empty(n, dtype=torch.int64, device=device)
        g["metrics"] = torch.zeros((B, 5), dtype=torch.float64,
                                   device=device)
        g["h2d_done"] = torch.cuda.Event()

    # -- the one-time capture ------------------------------------------------
    def _capture(self, carry, train_stack, test_stack, first):
        """Warm up and capture the round and eval graphs on a scratch copy
        of the carry, with the block's first staged round as the input."""
        g = self._graphs
        K, rows, _ = g["shape"]
        step, evaluate = self.block_fn.step, self.block_fn.evaluate
        t0 = time.perf_counter()
        if self.mesh is not None:
            # NCCL makes its communicator at a group's first collective,
            # which must not happen inside the capture
            self.mesh.warm_up(first.device)

        def scratch(v):
            if isinstance(v, dict):
                return {k: t.clone() for k, t in v.items()}
            return None if v is None else v.to(first.device, copy=True)

        static = {k: scratch(v) for k, v in carry.items()}
        s_in = first.clone()
        s_out = torch.zeros(5, dtype=torch.float64, device=first.device)

        def round_body():
            # the slot: K cohort ids, K alive flags, then the K·S·B rows
            bix = s_in[2 * K:].view((K,) + rows)
            new, (loss, disc, n_quar) = step(
                static, train_stack, s_in[:K], bix,
                s_in[K:2 * K].to(torch.float32))
            for dst, src in zip(_leaves(static), _leaves(new)):
                if src is not dst:
                    dst.copy_(src)
            static["membership"].copy_(new["membership"])
            s_out.zero_()
            s_out[0] = loss
            s_out[1] = disc
            s_out[4] = n_quar

        def eval_body():
            correct, total = evaluate(static, test_stack)
            s_out[2] = correct
            s_out[3] = total

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                round_body()
                eval_body()
        torch.cuda.current_stream().wait_stream(side)
        try:
            with gc_paused():
                round_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(round_graph):
                    round_body()
                eval_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(eval_graph, pool=round_graph.pool()):
                    eval_body()
        except Exception as e:
            raise RuntimeError(
                "CUDA graph capture of the fused round failed (a host sync "
                "inside the round?); round blocks do not run eagerly on "
                "the card") from e
        torch.cuda.synchronize()
        g.update(round=round_graph, eval=eval_graph, carry=static,
                 input=s_in, output=s_out)
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3


class Dispatch(NamedTuple):
    """One async dispatch: ``result`` (``make_async_dispatch_executor``'s
    dict), ``metrics`` ((3 + K,) float64 on the host; on the card a pinned
    buffer that holds the values once the event recorded after the
    dispatch has completed), the staged ``idx`` and ``alive`` on the
    result's device (the fold's scatter rows), and the result ``slot``
    (-1 on the CPU)."""
    result: dict
    metrics: torch.Tensor
    idx: torch.Tensor
    alive: torch.Tensor
    slot: int = -1


class GraphDispatchExecutor:
    """``executor(carry, train_stack, idx, bidx, alive) -> Dispatch`` with
    ``dispatch_fn``'s arguments (``fed.rounds.make_async_dispatch_
    executor``), the staged idx / bidx / alive as host tensors. On CPU
    tensors it runs ``dispatch_fn`` eagerly; on the card it replays the
    captured step (see the module docstring) or raises. ``release(d)``
    gives a dispatch's result slot back once its fold is enqueued (or its
    lease abandoned). ``replays`` counts the replays, ``captures`` the
    captures, ``capture_ms`` the one-time warm-up and capture. ``mesh``:
    the data mesh ``dispatch_fn`` was built for (its backend picks the
    route on the card)."""

    def __init__(self, dispatch_fn, depth: int, mesh=None):
        self.dispatch_fn = dispatch_fn
        self.slots = int(depth) + 1
        self.mesh = mesh
        self.eager_on_card = mesh is not None and mesh.backend == "gloo"
        self.captures = 0
        self.replays = 0
        self.capture_ms = None
        self._g = None

    def __call__(self, carry, train_stack, idx, bidx, alive) -> Dispatch:
        dev = train_stack[0].device
        if dev.type != "cuda" or self.eager_on_card:
            idx, bidx, alive = (t.to(dev) for t in (idx, bidx, alive))
            result, metrics = self.dispatch_fn(carry, train_stack, idx,
                                               bidx, alive)
            return Dispatch(result, metrics.cpu(), idx, alive)
        with torch.cuda.device(train_stack[0].device):
            return self._replay(carry, train_stack, idx, bidx, alive)

    def bind(self, carry: dict) -> dict:
        """The live carry of a run: once the step is captured, ``carry``'s
        values in the graph's input buffers (which the run then updates in
        place); ``carry`` itself before."""
        if self._g is None or "inputs" not in self._g:
            return carry
        ins = self._g["inputs"]
        for k, dst in ins["group_params"].items():
            dst.copy_(carry["group_params"][k])
        for key in ("membership", "aux"):
            if ins[key] is not None and ins[key] is not carry[key]:
                ins[key].copy_(carry[key])
        return dict(carry, **ins)

    def release(self, d: Dispatch):
        if d.slot >= 0:
            self._g["free"].append(d.slot)

    def _replay(self, carry, train_stack, idx, bidx, alive) -> Dispatch:
        K = idx.shape[0]
        shape = (K, tuple(bidx.shape[1:]), carry["membership"].shape[0])
        if self._g is None:
            self._allocate(shape, train_stack[0].device)
        g = self._g
        if shape != g["shape"]:
            raise ValueError(f"dispatch of shape {shape} (K, rows, N + 1) "
                             f"differs from the captured {g['shape']}")
        if not g["free"]:
            raise RuntimeError("no free result slot: more dispatches in "
                               f"flight than the pool's {self.slots}")
        j = g["free"].pop(0)
        # this slot's previous dispatch (folded or abandoned) has finished
        # reading its host buffer and writing its host metrics
        g["done"][j].synchronize()
        host = g["host_in"][j]
        host[:K].copy_(idx)
        host[K:2 * K].copy_(alive)
        host[2 * K:].copy_(bidx.reshape(-1))
        g["input"].copy_(host, non_blocking=True)
        if "graph" not in g:
            self._capture(carry, train_stack)
        static = g["inputs"]
        for k, dst in static["group_params"].items():
            if dst.data_ptr() != carry["group_params"][k].data_ptr():
                dst.copy_(carry["group_params"][k])
        for key in ("membership", "aux"):
            dst, src = static[key], carry[key]
            if dst is not None and dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        g["graph"].replay()
        self.replays += 1
        out, slot = g["output"], g["slots"][j]
        for key in ("group_params", "global_params"):
            for k, dst in slot[key].items():
                dst.copy_(out[key][k])
        for key in ("group_delta", "membership", "aux"):
            if slot[key] is not None:
                slot[key].copy_(out[key])
        slot["idx"].copy_(g["input"][:K])
        slot["alive"].copy_(g["input"][K:2 * K])
        g["host_metrics"][j].copy_(g["metrics"], non_blocking=True)
        g["done"][j].record()
        result = {k: slot[k] for k in ("group_params", "global_params",
                                       "group_delta", "membership", "aux")}
        return Dispatch(result, g["host_metrics"][j], slot["idx"],
                        slot["alive"], j)

    def _allocate(self, shape, device):
        K, rows, _ = shape
        n = 2 * K + K * math.prod(rows)
        self._g = {"shape": shape, "free": list(range(self.slots)),
                   "host_in": [torch.empty(n, dtype=torch.int64,
                                           pin_memory=True)
                               for _ in range(self.slots)],
                   "done": [torch.cuda.Event() for _ in range(self.slots)],
                   "input": torch.empty(n, dtype=torch.int64, device=device)}

    def _capture(self, carry, train_stack):
        """Warm up and capture the step on the carry itself (the step only
        reads it) with the first staged cohort as the input, then make the
        result slots in the outputs' shapes."""
        g = self._g
        K, rows, _ = g["shape"]
        s_in = g["input"]
        t0 = time.perf_counter()
        if self.mesh is not None:
            # NCCL makes its communicator at a group's first collective,
            # which must not happen inside the capture
            self.mesh.warm_up(s_in.device)

        def body():
            return self.dispatch_fn(carry, train_stack, s_in[:K],
                                    s_in[2 * K:].view((K,) + rows),
                                    s_in[K:2 * K].to(torch.float32))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body()
        torch.cuda.current_stream().wait_stream(side)
        try:
            with gc_paused():
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    output, metrics = body()
        except Exception as e:
            raise RuntimeError(
                "CUDA graph capture of the async dispatch failed (a host "
                "sync inside the round?); async dispatches do not run "
                "eagerly on the card") from e
        torch.cuda.synchronize()

        def like(v):
            if isinstance(v, dict):
                return {k: torch.empty_like(t) for k, t in v.items()}
            return None if v is None else torch.empty_like(v)

        g["slots"] = [dict({k: like(v) for k, v in output.items()},
                           idx=torch.empty(K, dtype=torch.int64,
                                           device=s_in.device),
                           alive=torch.empty(K, dtype=torch.float32,
                                             device=s_in.device))
                      for _ in range(self.slots)]
        g["host_metrics"] = [torch.empty(metrics.shape, dtype=metrics.dtype,
                                         pin_memory=True)
                             for _ in range(self.slots)]
        # what the step reads of the carry, by reference
        g.update(graph=graph, output=output, metrics=metrics,
                 inputs={"group_params": dict(carry["group_params"]),
                         "membership": carry["membership"],
                         "aux": carry["aux"]})
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3

