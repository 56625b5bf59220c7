"""In-process serve fleet: the kubelet of the ServeService world. The
port's counterpart of tf_operator_tpu/serve/fleet.py.

The ServeService controller (controller/serve.py) reconciles pod
*records* on the substrate; this module gives those records a live
body — one real decode server (make_server, continuous batching) per
replica pod, wired into a LeastLoadedRouter — so the failover and
rolling-update semantics run against actual sockets, engines, and
captured decode programs instead of mocks.

Three jobs:

- InProcessFleet.sync() boots a server for each pending serve pod,
  marks it Running, and registers it with the router; kill() is the
  chaos hammer (RST every live connection, stop the engine, terminate
  the pod record with exit 137); update_weights() is the controller's
  weight_update hook — drain the engine through its lifecycle gate,
  copy the new weights into its model in place, readmit.

- FaultyClientFactory wraps the router's DecodeClient with seeded
  connection-reset injection (pre-connect and mid-stream), logged to
  a chaos FaultLog as FAULT_CONN_RESET.

- run_failover_soak() is the end-to-end robustness proof: N replicas,
  concurrent streams, seeded 137 kills mid-stream plus injected resets —
  every accepted stream must complete with the greedy chain the model
  produces inline, with zero lost streams and failovers visible in the
  flight recorder under each request's correlation ID.

Weights: `params_by_version` maps a weights version to a state dict of
the port's GPT (or a GPT whose state dict it is). Every replica builds
a GPT of its own from it: the engine's swap_params copies into its
model's tensors, which its captured programs read, so two replicas
sharing one module would both change at the first swap. Replicas run
on `device` (cuda unless the caller names another); the smoke functions
take the model config (GPT_TINY by default) and the device, and take
their expected chains from the port's inline `generate` on the same
weights.

    python -m tf_operator_tpu_torch.serve.fleet --soak --seed 0 --device cpu
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import k8s
from ..api.types import (
    LABEL_SERVE_NAME,
    LABEL_SERVE_ROLE,
    LABEL_SERVE_WEIGHTS,
    SERVE_CONTAINER_NAME,
    ServeReplicaGroup,
    ServeService,
    ServeServiceSpec,
)
from ..chaos.faults import FAULT_CONN_RESET, FAULT_LATENCY, FAULT_POD_DEATH, FaultLog
from ..runtime.retry import RetryPolicy
from ..telemetry.flight import default_flight
from ..utils import locks
from .client import DecodeClient
from .router import LeastLoadedRouter

logger = logging.getLogger("tf_operator_tpu_torch.serve.fleet")


def _state_dict(params) -> dict:
    """A version's weights as a state dict (a GPT is taken by its own)."""
    import torch

    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def replica_model(cfg, params, device):
    """A GPT of its own on `device` holding `params`' values, built on the
    meta device so no random initialisation is paid first (the GPT has no
    buffer outside its state dict)."""
    import torch

    from ..models import gpt as gpt_lib

    with torch.device("meta"):
        model = gpt_lib.GPT(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(_state_dict(params))
    return model


def _collect() -> None:
    """Collect a torn-down replica now. Once its handler threads (whose
    frames hold its state) have ended, its server, state and engine are
    held only by one another, in reference cycles, and the engine holds
    the replica's weights, KV pool and captured graphs on the device."""
    gc.collect()


class _ReplicaProcess:
    """One booted replica: server + serve_forever thread + pod name."""

    def __init__(self, pod_name: str, server, thread, boot: dict) -> None:
        self.pod_name = pod_name
        self.server = server
        self.thread = thread
        # its entry of InProcessFleet.boot_log (filled in at teardown)
        self.boot = boot

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"


class InProcessFleet:
    """Boots/terminates real decode servers to match serve pod records.

    The substrate's kubelet simulator flips pod phases; this flips the
    matching processes. Deliberately pull-based (call sync() after
    pumping the controller) so tests control exactly when replicas
    come up — the router's probe loop covers the in-between.

    Besides the reference's counters (boots, kills) it keeps, per
    replica it has run, the captures of its engine's programs at
    teardown (`captures`, one entry a teardown), each boot's start and ready times
    (`boot_log`), and each rolling-update swap's time (`swapped_at`) and
    its drain and swap seconds (`update_log`)."""

    def __init__(
        self,
        substrate,
        router: LeastLoadedRouter,
        cfg,
        params_by_version: Dict[str, object],
        slots: int = 2,
        mesh_shape: str = "",
        namespace: Optional[str] = None,
        fault_log: Optional[FaultLog] = None,
        block_size: int = 64,
        prefill_chunk: int = 64,
        tenant_quotas: Optional[Dict[str, Dict]] = None,
        device=None,
    ) -> None:
        from .._device import resolve_device

        self.substrate = substrate
        self.router = router
        self.cfg = cfg
        # weightsVersion tag -> state dict; "" maps to the tag the
        # fleet should serve for pods created before a version was set
        self.params_by_version = params_by_version
        self.slots = slots
        # paged-KV geometry every replica boots with unless its pod
        # command overrides it (role groups append --slots /
        # --prefill-chunk; _command_int honors the override)
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        # ServeServiceSpec.mesh_shape ("1x2"); every replica this fleet
        # boots shares the one decode mesh shape. The port's server
        # refuses a mesh (sharded decode is not ported), and that
        # refusal reaches the caller of sync() unchanged
        self.mesh_shape = mesh_shape
        self.namespace = namespace
        # per-tenant QoS quotas every replica boots with (the
        # in-process analog of --tenant-quotas on the pod command)
        self.tenant_quotas = tenant_quotas
        self.fault_log = fault_log
        self.device = resolve_device(device)
        self._lock = locks.make_lock("InProcessFleet._lock")
        self._replicas: Dict[str, _ReplicaProcess] = {}
        self.boots = 0
        self.kills = 0
        self.captures: List[dict] = []
        self.boot_log: List[dict] = []
        self.swapped_at: Dict[str, float] = {}
        self.update_log: List[dict] = []

    def _params_for(self, version: str):
        try:
            return self.params_by_version[version]
        except KeyError:
            raise KeyError(
                f"no params registered for weights version {version!r} "
                f"(have: {sorted(self.params_by_version)})"
            ) from None

    @staticmethod
    def _command_int(pod: k8s.Pod, flag: str, default: int) -> int:
        """Read an int flag off the pod's serve-container command,
        last occurrence winning (argparse semantics — role groups
        APPEND their overrides after the template-wide defaults)."""
        value = default
        for container in pod.spec.containers:
            if container.name != SERVE_CONTAINER_NAME:
                continue
            command = container.command or []
            for i, tok in enumerate(command):
                if tok == flag and i + 1 < len(command):
                    try:
                        value = int(command[i + 1])
                    except ValueError:
                        pass
        return value

    @staticmethod
    def _command_str(pod: k8s.Pod, flag: str, default: str) -> str:
        """String twin of _command_int, same last-wins semantics."""
        value = default
        for container in pod.spec.containers:
            if container.name != SERVE_CONTAINER_NAME:
                continue
            command = container.command or []
            for i, tok in enumerate(command):
                if tok == flag and i + 1 < len(command):
                    value = command[i + 1]
        return value

    def sync(self) -> List[str]:
        """Boot a server for every pending serve pod without one, and
        drain-decommission every live replica whose pod record the
        reconciler deleted (scale-in). Returns the pod names booted
        this pass."""
        from .server import make_server

        self.reap()
        booted: List[str] = []
        pods = self.substrate.list_pods(self.namespace)
        for pod in pods:
            name = pod.metadata.name
            if LABEL_SERVE_NAME not in pod.metadata.labels:
                continue
            if pod.status.phase != k8s.POD_PENDING:
                continue
            with self._lock:
                if name in self._replicas:
                    continue
            version = pod.metadata.labels.get(LABEL_SERVE_WEIGHTS, "")
            params = self._params_for(version)
            # role-typed replica groups: the controller stamps the
            # role label and appends per-role --slots/--prefill-chunk
            # to the pod command; the fleet is the kubelet that obeys
            role = pod.metadata.labels.get(LABEL_SERVE_ROLE, "")
            n_slots = self._command_int(pod, "--slots", self.slots)
            prefill_chunk = self._command_int(
                pod, "--prefill-chunk", self.prefill_chunk
            )
            # speculative decoding rides the command line the same way;
            # the controller only stamps it on decode groups, and a
            # prefill role with a stray flag is refused by make_server
            speculate = self._command_str(pod, "--speculate", "off")
            spec_depth = self._command_int(pod, "--spec-depth", 4)
            started = time.monotonic()
            # the replica's own module: no tensor is shared with another
            # replica, whose swap copies into its own
            model = replica_model(self.cfg, params, self.device)
            # warm_async: the listener binds first, /readyz answers
            # "warming" (503) while the engine is built and its programs
            # captured, and the router only admits the replica when its
            # probe sees ready — the boot sequence a real pod walks
            server = make_server(
                model, port=0, model_name=name,
                batching="continuous", n_slots=n_slots,
                mesh_shape=self.mesh_shape or None,
                warm_async=True,
                block_size=self.block_size,
                prefill_chunk=prefill_chunk,
                role=role,
                tenant_quotas=self.tenant_quotas,
                speculate=speculate, spec_depth=spec_depth,
                device=self.device,
            )
            # a short poll interval: a kill's shutdown() returns within
            # 50 ms, so the replacement boots while streams are in flight
            thread = threading.Thread(
                target=server.serve_forever, kwargs={"poll_interval": 0.05},
                name=f"serve-{name}", daemon=True,
            )
            thread.start()
            proc = _ReplicaProcess(
                name, server, thread, {"pod": name, "started": started, "ready_at": None})
            with self._lock:
                self._replicas[name] = proc
                self.boot_log.append(proc.boot)
            self.boots += 1
            self.substrate.mark_pod_running(
                pod.metadata.namespace, name
            )
            self.router.add_replica(name, proc.url, role=role)
            booted.append(name)
            logger.info(
                "booted replica %s at %s%s", name, proc.url,
                f" (role {role})" if role else "",
            )
        return booted

    def reap(self) -> List[str]:
        """Drain-decommission live replicas whose pod records are gone
        from the substrate — the reconciler scaled the group in (or
        removed a role group) by deleting the pod, and the fleet is
        the kubelet that retires the body. The graceful inverse of
        kill(): zero lost streams. Returns the names decommissioned."""
        present = {
            pod.metadata.name
            for pod in self.substrate.list_pods(self.namespace)
            if LABEL_SERVE_NAME in pod.metadata.labels
        }
        with self._lock:
            departed = [
                name for name in self._replicas if name not in present
            ]
        for name in departed:
            self.decommission(name)
        return departed

    def decommission(self, pod_name: str) -> None:
        """Gracefully retire one replica: router stops picking it,
        the server 503s new work, the engine finishes its in-flight
        slots behind the admission gate (the same drain sequence the
        rolling weight update walks), and only then do the listener
        and engine come down — so scale-in loses zero streams."""
        with self._lock:
            proc = self._replicas.pop(pod_name, None)
        if proc is None:
            return
        self.router.set_draining(pod_name, True)
        state = proc.server.state
        try:
            state.phase = "draining"
            self._join_warmup(proc)
            engine = state.engine
            if engine is not None and not engine.drain(timeout=60.0):
                logger.warning(
                    "replica %s did not drain within 60s; "
                    "decommissioning anyway", pod_name,
                )
        finally:
            proc.server.shutdown()
            self._quiesce_engine(proc)
            proc.server.server_close()
            self.router.remove_replica(pod_name)
        proc.server.join_handlers(timeout=10.0)
        del proc, state
        _collect()
        logger.info("decommissioned replica %s (drained)", pod_name)

    def kill(self, pod_name: str, exit_code: int = 137) -> None:
        """Chaos kill: sever every live connection with an RST (the
        in-process analog of the kernel tearing down a dead process's
        sockets), stop the listener and engine, and terminate the pod
        record so the controller reaps and replaces it."""
        with self._lock:
            proc = self._replicas.pop(pod_name, None)
        if proc is None:
            raise KeyError(f"no live replica {pod_name!r}")
        self.kills += 1
        if self.fault_log is not None:
            self.fault_log.append(
                "fleet.kill", FAULT_POD_DEATH, f"{pod_name} exit={exit_code}"
            )
        aborted = proc.server.abort_connections()
        proc.server.shutdown()
        # stop the engine BEFORE server_close joins handler threads: a
        # handler blocked on a queued request would otherwise wait out
        # its stream timeout (stop() fails queued requests fast)
        self._quiesce_engine(proc)
        proc.server.server_close()
        self.router.remove_replica(pod_name)
        proc.server.join_handlers(timeout=10.0)
        del proc
        _collect()
        # find the pod's namespace from the record (terminate_pod needs it)
        for pod in self.substrate.list_pods(self.namespace):
            if pod.metadata.name == pod_name:
                self.substrate.terminate_pod(
                    pod.metadata.namespace, pod_name, exit_code=exit_code
                )
                break
        logger.info(
            "killed replica %s (exit %d, %d connections reset)",
            pod_name, exit_code, aborted,
        )

    @staticmethod
    def _join_warmup(proc: _ReplicaProcess) -> None:
        """An engine still being built (and capturing) is waited for,
        not abandoned: its thread would otherwise finish the build and
        start an engine after its replica was torn down."""
        warmup = proc.server.state.warmup_thread
        if warmup is not None and warmup.is_alive():
            warmup.join(timeout=120.0)

    def _quiesce_engine(self, proc: _ReplicaProcess) -> None:
        """Settle a replica's engine before teardown: join an async
        warm-up still running, note the captures of its programs, and
        stop it (a step in flight finishes first; queued and active
        requests fail fast)."""
        self._join_warmup(proc)
        proc.boot["ready_at"] = proc.server.state.ready_at
        engine = proc.server.state.engine
        if engine is not None:
            step = engine.step
            self.captures.append({
                "pod": proc.pod_name, "step": step.compiles,
                "prefill": getattr(step, "prefill_compiles", 0),
            })
            engine.stop()

    def update_weights(
        self, svc: ServeService, pods: List[k8s.Pod]
    ) -> List[str]:
        """The controller's weight_update hook: in-place drain + swap
        for each pod in the batch. Sequence per replica — router stops
        picking it, server 503s new work, engine finishes in-flight
        slots behind the admission gate, the new weights are copied into
        the engine's model under the lifecycle lock (its captured
        programs read those tensors: no recapture), then everything
        readmits. The server's other paths (beam search) decode with
        state.model, the engine's own module, so they serve the new
        weights too. Returns the names actually updated (the reconciler
        patches their weights label)."""
        version = svc.spec.weights_version
        params = _state_dict(self._params_for(version))
        updated: List[str] = []
        for pod in pods:
            name = pod.metadata.name
            with self._lock:
                proc = self._replicas.get(name)
            if proc is None:
                continue  # died since the controller listed it
            state = proc.server.state
            engine = state.engine
            self.router.set_draining(name, True)
            try:
                state.phase = "draining"
                began = time.monotonic()
                if not engine.drain(timeout=60.0):
                    raise RuntimeError(
                        f"replica {name} did not drain within 60s"
                    )
                drained = time.monotonic()
                engine.swap_params(params)
                self.swapped_at[name] = time.monotonic()
                self.update_log.append({
                    "pod": name, "drain_s": drained - began,
                    "swap_s": self.swapped_at[name] - drained,
                })
                engine.resume_admission()
                state.phase = "ready"
                updated.append(name)
            finally:
                self.router.set_draining(name, False)
                self.router.probe(name)
        return updated

    def wait_ready(self, want: int, timeout: float = 120.0) -> None:
        """Block until `want` replicas answer ready at the router."""
        deadline = time.monotonic() + timeout
        while True:
            self.router.probe()
            stats = self.router.stats()
            ready = sum(
                1 for r in stats["replicas"].values() if r["ready"]
            )
            if ready >= want:
                return
            with self._lock:
                failed = sorted(name for name, proc in self._replicas.items()
                                if proc.server.state.phase == "failed")
            if failed:
                # an async warm-up that raised (its log has the error)
                raise RuntimeError(f"replica warm-up failed: {failed}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {ready}/{want} replicas ready after {timeout}s"
                )
            time.sleep(0.05)

    def boots_report(self) -> List[dict]:
        """Each boot: its pod, seconds from the start of its build to
        ready (None if it never came ready), and its start and ready
        times on time.monotonic()."""
        with self._lock:
            for proc in self._replicas.values():
                proc.boot["ready_at"] = proc.server.state.ready_at
            log = list(self.boot_log)
        out = []
        for entry in log:
            ready = entry["ready_at"]
            out.append({
                "pod": entry["pod"], "started": entry["started"], "ready_at": ready,
                "seconds": None if ready is None else ready - entry["started"],
            })
        return out

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def engines(self) -> Dict[str, object]:
        """Live replica name -> its engine (None while warming)."""
        with self._lock:
            return {
                name: proc.server.state.engine
                for name, proc in self._replicas.items()
            }

    def stop(self) -> None:
        with self._lock:
            procs = list(self._replicas.values())
            self._replicas.clear()
        while procs:
            proc = procs.pop(0)
            proc.server.shutdown()
            self._quiesce_engine(proc)
            proc.server.server_close()
            self.router.remove_replica(proc.pod_name)
            proc.server.join_handlers(timeout=10.0)
            del proc
        _collect()


# -- fault injection --------------------------------------------------------


class _FaultyStream:
    """Wraps a replica stream; raises an injected reset after k events."""

    def __init__(self, inner, cut_after: int) -> None:
        self._inner = inner
        self._cut_after = cut_after
        self._count = 0

    def __iter__(self):
        for event in self._inner:
            if self._count >= self._cut_after:
                self._inner.close()
                raise ConnectionResetError(
                    "chaos: injected mid-stream connection reset"
                )
            self._count += 1
            yield event


class _FaultyClient:
    """DecodeClient proxy with seeded connection-reset injection on
    generate_stream. Everything else passes straight through."""

    def __init__(self, inner: DecodeClient, factory) -> None:
        self._inner = inner
        self._factory = factory

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def generate_stream(self, input_ids, max_new_tokens: int = 16, **kw):
        cut_after = self._factory.draw(self._inner.base_url)
        if cut_after == 0:
            # pre-connect reset: the replica was never reached, so the
            # router retries without any tokens at stake
            raise ConnectionResetError(
                "chaos: injected pre-connect connection reset"
            )
        inner = self._inner.generate_stream(
            input_ids, max_new_tokens, **kw
        )
        if cut_after is None:
            return inner
        return iter(_FaultyStream(inner, cut_after))


class FaultyClientFactory:
    """Router client_factory that injects FAULT_CONN_RESET faults from
    one seeded rng: per generate_stream call, with `probability`, the
    connection is reset either before connect (cut_after 0) or after
    1..3 events, at most `max_count` times total. Deterministic given
    the seed AND the call order — concurrency shuffles which stream
    draws which fault, so soaks assert on totals, not placements."""

    def __init__(
        self,
        seed: int,
        probability: float = 0.25,
        max_count: int = 3,
        fault_log: Optional[FaultLog] = None,
    ) -> None:
        self._rng = random.Random(seed)
        self._lock = locks.make_lock("FaultyClientFactory._lock")
        self.probability = probability
        self.max_count = max_count
        self.fault_log = fault_log
        self.injected = 0

    def draw(self, url: str) -> Optional[int]:
        """None = no fault this call; 0 = pre-connect reset; k>0 =
        reset after k stream events."""
        with self._lock:
            if self.injected >= self.max_count:
                return None
            if self._rng.random() >= self.probability:
                return None
            self.injected += 1
            cut_after = self._rng.randint(0, 3)
        if self.fault_log is not None:
            self.fault_log.append(
                "router.generate_stream", FAULT_CONN_RESET,
                f"{url} cut_after={cut_after}",
            )
        return cut_after

    def __call__(self, url: str) -> _FaultyClient:
        return _FaultyClient(
            DecodeClient(
                url, timeout=60.0,
                retry_policy=RetryPolicy(max_attempts=1),
            ),
            self,
        )


class _SlowStream:
    """Stream proxy that sleeps once before the first event — added
    TTFT, not added ITL, so the burn-rate rule on the router's TTFT
    series is what trips."""

    def __init__(self, inner, delay_s: float) -> None:
        self._inner = iter(inner)
        self._delay_s = delay_s

    def __iter__(self):
        return self

    def __next__(self):
        if self._delay_s > 0:
            time.sleep(self._delay_s)
            self._delay_s = 0.0
        return next(self._inner)


class _SlowClient:
    """DecodeClient proxy adding the factory's current pre-first-token
    latency. Everything else passes straight through."""

    def __init__(self, inner: DecodeClient, factory) -> None:
        self._inner = inner
        self._factory = factory

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def generate_stream(self, input_ids, max_new_tokens: int = 16, **kw):
        delay = self._factory.draw(
            self._inner.base_url, tenant=kw.get("tenant")
        )
        inner = self._inner.generate_stream(
            input_ids, max_new_tokens, **kw
        )
        if delay <= 0:
            return inner
        return iter(_SlowStream(inner, delay))


class LatencyClientFactory:
    """Router client_factory injecting FAULT_LATENCY through the chaos
    layer: while `delay_s` > 0, every generate_stream gains that much
    TTFT and the injection is logged to the FaultLog (which forwards
    to the flight recorder). The alert smoke flips delay_s on to push
    the fleet out of SLO and back off to let it recover."""

    def __init__(self, fault_log: Optional[FaultLog] = None) -> None:
        self.delay_s = 0.0
        # when set, only streams carrying this tenant id are slowed —
        # the mixed-tenant bench's noisy neighbor, leaving every other
        # tenant's TTFT untouched
        self.only_tenant = ""
        self.fault_log = fault_log
        self.injected = 0

    def draw(self, url: str, tenant: Optional[str] = None) -> float:
        if self.only_tenant and tenant != self.only_tenant:
            return 0.0
        delay = self.delay_s
        if delay > 0:
            self.injected += 1
            if self.fault_log is not None:
                self.fault_log.append(
                    "router.generate_stream", FAULT_LATENCY,
                    f"{url} +{delay:.3f}s ttft",
                )
        return delay

    def __call__(self, url: str) -> _SlowClient:
        return _SlowClient(
            DecodeClient(
                url, timeout=60.0,
                retry_policy=RetryPolicy(max_attempts=1),
            ),
            self,
        )


# -- the smokes' shared set-up ----------------------------------------------


def seeded_params(cfg, seed: int = 0) -> dict:
    """The state dict of a GPT(cfg) drawn from `seed` on the host: the
    port's stand-in for the reference's GPT(cfg).init(PRNGKey(seed))."""
    import torch

    from ..models import gpt as gpt_lib

    model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in model.state_dict().items()}


def _smoke_setup(cfg, device, params):
    """(cfg, device, params) with the smokes' defaults: GPT_TINY, cuda
    unless named, and weights drawn from seed 0."""
    from .._device import resolve_device
    from ..models import gpt as gpt_lib

    cfg = cfg if cfg is not None else gpt_lib.GPT_TINY
    device = resolve_device(device)
    if params is None:
        params = seeded_params(cfg, 0)
    return cfg, device, _state_dict(params)


def inline_chains(cfg, params, prompts: List[List[int]], max_new: int,
                  device) -> List[List[int]]:
    """Each prompt's greedy chain from the port's inline `generate`, one
    call a prompt, on a model of `params` on `device`: the ground truth a
    served stream must match (greedy chains are pure functions of the
    prompt)."""
    import torch

    from ..models import gpt as gpt_lib

    model = replica_model(cfg, params, device)
    out = []
    with torch.no_grad():
        for prompt in prompts:
            row = torch.tensor([prompt], dtype=torch.long, device=device)
            out.append([int(t) for t in gpt_lib.generate(model, row, max_new)[0].tolist()])
    del model
    return out


def _exact(prompt: List[int], got: List[int], want: List[int]) -> Optional[str]:
    """The reference's criterion: bit-identity with inline greedy decode."""
    return None if got == want else "differs from the inline chain"


def _quantiles(values: List[float]) -> Dict[str, Optional[float]]:
    """p50 and p95 (nearest rank) of `values`, None when empty."""
    if not values:
        return {"p50": None, "p95": None}
    ordered = sorted(values)

    def pick(q: float) -> float:
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    return {"p50": pick(0.50), "p95": pick(0.95)}


def _memory_allocated(device) -> Optional[int]:
    """torch.cuda.memory_allocated on a CUDA device (what a collection
    leaves), else None."""
    import torch

    if device.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(device)
    return int(torch.cuda.memory_allocated(device))


# -- the soak ---------------------------------------------------------------


def run_failover_soak(
    seed: int = 0,
    replicas: int = 3,
    streams: int = 6,
    kills: int = 1,
    max_new: int = 12,
    conn_faults: int = 2,
    namespace: str = "chaos",
    cfg=None,
    device=None,
    params=None,
    slots: int = 2,
    prompt_len=(2, 5),
    chain_check: Optional[Callable] = None,
    sustain: bool = False,
) -> dict:
    """Chaos-prove the fleet: boot `replicas` engine replicas of `slots`
    slots under the ServeService controller, run `streams` concurrent
    streams (prompts of `prompt_len` tokens, inclusive) through the
    router while killing `kills` replicas with exit 137 mid-stream and
    injecting `conn_faults` connection resets, then pin every accepted
    stream to the inline greedy chain. Raises AssertionError on any lost
    or diverged stream.

    A victim is drawn from the live replicas that have streamed a token,
    once the first token has streamed: the kill cuts streams in flight,
    and the controller's replacement boots at once. sustain: each of the
    `streams` client threads opens its next stream (the next prompt of the
    family) as soon as one ends, until every replacement is ready, so the
    replacements are built and capture their programs while the other
    replicas serve (without it, as the reference, each thread streams
    once). chain_check(prompt, got, want) -> None or a problem decides
    whether a served chain `got` stands against the inline `want` (default:
    bit-identity, the reference's criterion); a chain accepted while it
    differs is listed under "near_ties". The summary adds to the
    reference's: captures per replica, each boot's seconds and the streams
    in flight while it booted, client TTFT and inter-token p50/p95, and on
    a CUDA device the memory allocated after the boots, after each kill and
    after the replacements came ready."""
    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate

    cfg, device, params = _smoke_setup(cfg, device, params)
    check = chain_check or _exact

    rng = random.Random(seed)
    flight = default_flight()
    fault_log = FaultLog(flight=flight, seed=seed)
    factory = FaultyClientFactory(
        seed=seed + 1, probability=0.35, max_count=conn_faults,
        fault_log=fault_log,
    )
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(client_factory=factory, retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=slots,
        namespace=namespace, fault_log=fault_log, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            replicas=replicas, preset="tiny", slots=slots,
            weights_version="v1",
        )
    )
    svc.metadata.name = "soak"
    svc.metadata.namespace = namespace

    low, high = prompt_len
    prompts = [
        [rng.randrange(1, cfg.vocab_size) for _ in range(rng.randint(low, high))]
        for _ in range(streams)
    ]
    expected = inline_chains(cfg, params, prompts, max_new, device)

    # one record a stream: its prompt, corr, chain or error, and its
    # start and end on time.monotonic()
    outcomes: List[dict] = []
    ttfts: List[float] = []
    itls: List[float] = []
    served_by: Dict[str, int] = {}
    meter = locks.make_lock("run_failover_soak.meter")
    first_token = threading.Event()
    sustaining = threading.Event()
    if sustain:
        sustaining.set()

    def _one_stream(i: int, corr: str) -> dict:
        rec = {"i": i, "corr": corr, "chain": None, "error": None,
               "start": time.monotonic(), "end": None}
        last = None
        try:
            final = None
            for event in router.generate_stream(
                prompts[i], max_new, corr=corr, timeout=120.0,
            ):
                if "token" in event:
                    now = time.monotonic()
                    with meter:
                        if last is None:
                            ttfts.append(now - rec["start"])
                        else:
                            itls.append(now - last)
                        replica = event.get("replica")
                        if replica:
                            served_by[replica] = served_by.get(replica, 0) + 1
                    last = now
                    first_token.set()
                if event.get("done"):
                    final = event
            rec["chain"] = final["tokens"][0] if final else None
        except Exception as err:  # noqa: BLE001 — recorded, asserted below
            rec["error"] = f"{type(err).__name__}: {err}"
        rec["end"] = time.monotonic()
        return rec

    def _run_client(i: int) -> None:
        k = 0
        while True:
            corr = f"soak-{seed}-{i}" + (f"-{k}" if k else "")
            rec = _one_stream((i + k) % streams, corr)
            with meter:
                outcomes.append(rec)
            k += 1
            if not sustaining.is_set():
                return

    def _ready() -> int:
        router.probe()
        return sum(1 for r in router.stats()["replicas"].values() if r["ready"])

    memory: List[dict] = []
    started = time.monotonic()
    performed_kills = 0
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(replicas)
        memory.append({"after": f"{replicas} boots", "bytes": _memory_allocated(device)})

        threads = [
            threading.Thread(
                target=_run_client, args=(i,), name=f"stream-{i}",
            )
            for i in range(streams)
        ]
        for t in threads:
            t.start()

        # wait for real traffic, then kill replicas mid-stream; pump
        # the controller so each kill is reaped and replaced, and
        # sync the fleet so the replacement pod gets a live server
        first_token.wait(timeout=60.0)
        while performed_kills < kills:
            live = fleet.replica_names()
            if not live:
                break
            with meter:
                streaming = [name for name in live if served_by.get(name)]
            victim = rng.choice(streaming or live)
            fleet.kill(victim, exit_code=137)
            performed_kills += 1
            memory.append({"after": f"kill of {victim}", "bytes": _memory_allocated(device)})
            controller.run_until_quiet()
            fleet.sync()
        # keep reconciling until every stream lands (replacement
        # replicas come ready mid-loop; the router probes them in)
        while any(t.is_alive() for t in threads):
            controller.run_until_quiet()
            fleet.sync()
            if sustaining.is_set() and _ready() >= replicas:
                sustaining.clear()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=120.0)
        fleet.wait_ready(replicas)
        memory.append({"after": "replacements ready", "bytes": _memory_allocated(device)})
    finally:
        sustaining.clear()
        fleet.stop()
        controller.stop()

    lost = [n for n, rec in enumerate(outcomes) if rec["chain"] is None]
    verdicts = {
        n: check(prompts[rec["i"]], rec["chain"], expected[rec["i"]])
        for n, rec in enumerate(outcomes) if rec["chain"] is not None
    }
    diverged = [n for n, why in verdicts.items() if why is not None]
    near_ties = [
        n for n, why in verdicts.items()
        if why is None and outcomes[n]["chain"] != expected[outcomes[n]["i"]]
    ]
    failovers = router.failovers
    # every failover must be visible in the flight ring under the
    # request's correlation ID
    recorded_failovers = sum(
        len([
            rec for rec in flight.snapshot(kind="serve", corr=out["corr"])
            if rec.fields.get("op") == "failover"
        ])
        for out in outcomes
    )
    boots = []
    for boot in fleet.boots_report():
        ready = boot["ready_at"]
        window = (boot["started"], ready if ready is not None else float("inf"))
        boots.append({
            "pod": boot["pod"], "seconds": boot["seconds"],
            # streams the other replicas were serving while this one was
            # built and captured its programs
            "streams_in_flight": sum(
                1 for rec in outcomes
                if rec["start"] < window[1] and rec["end"] > window[0]
            ),
        })
    summary = {
        "seed": seed,
        "replicas": replicas,
        "streams": len(outcomes),
        "clients": streams,
        "kills": performed_kills,
        "conn_faults_injected": factory.injected,
        "failovers": failovers,
        "recorded_failovers": recorded_failovers,
        "boots": fleet.boots,
        "lost": [f"{n}: {outcomes[n]['error']}" for n in lost],
        "diverged": [f"{n}: {verdicts[n]}" for n in diverged],
        "near_ties": near_ties,
        "seconds": round(time.monotonic() - started, 2),
        "captures": list(fleet.captures),
        "boot_log": boots,
        "ttft_s": _quantiles(ttfts),
        "itl_s": _quantiles(itls),
        "memory_allocated": memory,
        "prompts": prompts,
        "expected": expected,
        "chains": [rec["chain"] for rec in outcomes],
        "chain_prompt": [rec["i"] for rec in outcomes],
        "ok": not lost and not diverged
        and recorded_failovers >= failovers,
    }
    if not summary["ok"]:
        raise AssertionError(
            f"serve failover soak failed: {json.dumps(_short(summary))}"
        )
    return summary


def _short(summary: dict) -> dict:
    """The summary without its token lists (for messages and printing)."""
    return {k: v for k, v in summary.items()
            if k not in ("prompts", "expected", "chains", "chain_prompt")}


def run_rolling_update(
    seed: int = 0,
    replicas: int = 3,
    streams_per_wave: int = 3,
    max_new: int = 8,
    namespace: str = "roll",
    cfg=None,
    device=None,
    params=None,
    params2=None,
    slots: int = 2,
    prompt_len=(2, 5),
    chain_check: Optional[Callable] = None,
) -> dict:
    """A rolling weight update under a stream load, held per stream: the
    fleet serves v1 (`params`), client threads keep streaming, the
    ServeService's weightsVersion moves to v2 (`params2`, default weights
    drawn from seed 1) with maxUnavailable 1, and the controller drains and
    swaps one replica at a time through InProcessFleet.update_weights.

    Each stream's chain must be the inline chain of the version it was
    admitted under: v1 where its first token reached the client before its
    replica's swap, v2 otherwise (an engine drained for a swap admits
    nothing until the swap is done, and a stream admitted before it
    finishes before it). chain_check(prompt, got, want) as
    run_failover_soak's, or a dict of one a version (a check that reads
    the model, such as a margin rule, needs the version's weights). Held
    too: no stream lost, the update completed on
    every replica, every replica's programs captured once (a swap copies
    into the tensors the graphs read), and streams on both versions.
    Raises AssertionError otherwise."""
    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate

    cfg, device, params = _smoke_setup(cfg, device, params)
    params2 = _state_dict(params2 if params2 is not None else seeded_params(cfg, 1))
    checks = chain_check if isinstance(chain_check, dict) else {
        "v1": chain_check or _exact, "v2": chain_check or _exact}

    rng = random.Random(seed)
    low, high = prompt_len
    prompts = [
        [rng.randrange(1, cfg.vocab_size) for _ in range(rng.randint(low, high))]
        for _ in range(streams_per_wave)
    ]
    want = {
        "v1": inline_chains(cfg, params, prompts, max_new, device),
        "v2": inline_chains(cfg, params2, prompts, max_new, device),
    }

    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params, "v2": params2}, slots=slots,
        namespace=namespace, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace, weight_update=fleet.update_weights,
    )
    svc = ServeService(spec=ServeServiceSpec(
        replicas=replicas, preset="tiny", slots=slots, weights_version="v1",
        max_unavailable=1,
    ))
    svc.metadata.name = "roll"
    svc.metadata.namespace = namespace

    stop_flag = threading.Event()
    out_lock = locks.make_lock("run_rolling_update.outcomes")
    outcomes: List[dict] = []

    def traffic(worker: int) -> None:
        k = 0
        while not stop_flag.is_set():
            i = (worker + k) % len(prompts)
            rec = {"i": i, "chain": None, "error": None, "replica": None, "first": None}
            try:
                final = None
                for event in router.generate_stream(
                    prompts[i], max_new, corr=f"roll-{seed}-{worker}-{k}", timeout=120.0,
                ):
                    if rec["first"] is None and "token" in event:
                        rec["first"] = time.monotonic()
                        rec["replica"] = event.get("replica")
                    if event.get("done"):
                        final = event
                rec["chain"] = final["tokens"][0] if final else None
            except Exception as err:  # noqa: BLE001 — asserted below
                rec["error"] = f"{type(err).__name__}: {err}"
            with out_lock:
                outcomes.append(rec)
            k += 1

    threads = [
        threading.Thread(target=traffic, args=(w,), name=f"roll-{w}")
        for w in range(streams_per_wave)
    ]
    started = time.monotonic()
    update_s = None
    status = None
    compiles: Dict[str, int] = {}
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(replicas)
        for t in threads:
            t.start()
        # some traffic on the old weights first
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with out_lock:
                if len(outcomes) >= streams_per_wave:
                    break
            time.sleep(0.02)
        fresh = substrate.get_serve_service(namespace, "roll")
        fresh.spec.weights_version = "v2"
        substrate.update_serve_service(fresh)
        update_start = time.monotonic()
        deadline = update_start + 120
        while time.monotonic() < deadline:
            controller.run_until_quiet()
            status = substrate.get_serve_service(namespace, "roll").status
            if status.updated_replicas == replicas:
                break
            time.sleep(0.02)
        update_s = time.monotonic() - update_start
        # traffic on the new weights everywhere before the load stops
        with out_lock:
            seen = len(outcomes)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with out_lock:
                if len(outcomes) >= seen + streams_per_wave:
                    break
            time.sleep(0.02)
    finally:
        stop_flag.set()
        for t in threads:
            t.join(timeout=120)
        compiles = {
            name: engine.step.compiles
            for name, engine in fleet.engines().items() if engine is not None
        }
        fleet.stop()
        controller.stop()

    with out_lock:
        done = list(outcomes)
    problems: List[str] = []
    by_version = {"v1": 0, "v2": 0}
    near_ties = 0
    for n, rec in enumerate(done):
        if rec["chain"] is None:
            problems.append(f"stream {n} lost: {rec['error']}")
            continue
        swapped = fleet.swapped_at.get(rec["replica"])
        version = "v1" if swapped is None or rec["first"] < swapped else "v2"
        by_version[version] += 1
        expected = want[version][rec["i"]]
        why = checks[version](prompts[rec["i"]], rec["chain"], expected)
        if why is not None:
            problems.append(
                f"stream {n} on {rec['replica']} (admitted under {version}): {why}"
            )
        elif rec["chain"] != expected:
            near_ties += 1
    if status is None or status.updated_replicas != replicas:
        problems.append(
            f"update incomplete: {getattr(status, 'updated_replicas', None)}/{replicas}"
        )
    if sorted(fleet.swapped_at) != sorted(compiles) or len(compiles) != replicas:
        problems.append(f"swapped {sorted(fleet.swapped_at)}, live {sorted(compiles)}")
    if any(c != 1 for c in compiles.values()):
        problems.append(f"captures per replica {compiles} (1 each: the swap recaptures nothing)")
    if not by_version["v1"] or not by_version["v2"]:
        problems.append(f"streams per version {by_version}")
    summary = {
        "seed": seed,
        "replicas": replicas,
        "streams": len(done),
        "by_version": by_version,
        "near_ties": near_ties,
        "compiles": compiles,
        "update_seconds": update_s,
        "swap_times": {
            name: t - started for name, t in sorted(fleet.swapped_at.items())
        },
        "updates": list(fleet.update_log),
        "v1_differs_from_v2": [
            want["v1"][i] != want["v2"][i] for i in range(len(prompts))
        ],
        "problems": problems,
        "seconds": round(time.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(f"rolling update failed: {json.dumps(summary)}")
    return summary


def run_disagg_smoke(
    seed: int = 0,
    streams: int = 4,
    max_new: int = 12,
    namespace: str = "disagg",
    cfg=None,
    device=None,
    params=None,
) -> dict:
    """End-to-end proof of the disaggregated prefill/decode path: a
    ServeService with role-typed replica groups (1 prefill + 1 decode)
    reconciled by the real controller, booted by the fleet, routed by
    the prefix-aware router. A shared-prefix request family streams
    through the router; every chain must be bit-identical to the inline
    greedy reference, at least one KV block-set migration must actually
    happen, the decode pool must have served the streams, per-role
    status must be reported, and both block pools must audit clean at
    shutdown. Raises AssertionError on any violation."""
    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate

    cfg, device, params = _smoke_setup(cfg, device, params)

    rng = random.Random(seed)
    block_size = 8
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=2,
        namespace=namespace, block_size=block_size,
        prefill_chunk=block_size, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            preset="tiny", slots=2, weights_version="v1",
            replica_groups={
                "prefill": ServeReplicaGroup(replicas=1),
                "decode": ServeReplicaGroup(replicas=1),
            },
        )
    )
    svc.metadata.name = "disagg"
    svc.metadata.namespace = namespace

    # a shared-prefix family: every prompt opens with the same two
    # full blocks (the migratable prefix), then its own short tail
    shared = [
        rng.randrange(1, cfg.vocab_size) for _ in range(2 * block_size)
    ]
    prompts = [
        shared + [
            rng.randrange(1, cfg.vocab_size)
            for _ in range(rng.randint(1, 3))
        ]
        for _ in range(streams)
    ]
    expected = inline_chains(cfg, params, prompts, max_new, device)

    results: List[Optional[List[int]]] = [None] * streams
    errors: List[Optional[str]] = [None] * streams
    started = time.monotonic()
    role_status = {}
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)

        for i, prompt in enumerate(prompts):
            try:
                final = None
                for event in router.generate_stream(
                    prompt, max_new, corr=f"disagg-{seed}-{i}",
                    timeout=120.0,
                ):
                    if event.get("done"):
                        final = event
                results[i] = final["tokens"][0] if final else None
            except Exception as err:  # noqa: BLE001 — asserted below
                errors[i] = f"{type(err).__name__}: {err}"

        controller.run_until_quiet()
        fresh = substrate.get_serve_service(namespace, "disagg")
        role_status = {
            role: {
                "replicas": rs.replicas,
                "ready": rs.ready_replicas,
            }
            for role, rs in fresh.status.role_statuses.items()
        }
        stats = router.stats()
        engines = fleet.engines()
    finally:
        fleet.stop()
        controller.stop()

    # fleet.stop() -> engine.stop() runs the pool audit on every
    # replica; a failed audit is a counter, never a crash
    audit_failures = {
        name: engine.pool_audit_failures
        for name, engine in engines.items()
    }
    pools_empty = all(
        engine.pool is None or engine.pool.in_use() == 0
        for engine in engines.values()
    )
    migrations_out = sum(
        engine.migrations_out for engine in engines.values()
    )
    migrations_in = sum(
        engine.migrations_in for engine in engines.values()
    )
    decode_picks = sum(
        1 for d in stats["decisions"]
        if d["role_requested"] == "decode" and d["pool"] == "role"
    )
    lost = [i for i in range(streams) if results[i] is None]
    diverged = [
        i for i in range(streams)
        if results[i] is not None and results[i] != expected[i]
    ]
    summary = {
        "seed": seed,
        "streams": streams,
        "migrations": stats["migrations"],
        "migrate_failures": stats["migrate_failures"],
        "migrations_out": migrations_out,
        "migrations_in": migrations_in,
        "decode_pool_picks": decode_picks,
        "role_status": role_status,
        "audit_failures": audit_failures,
        "pools_empty": pools_empty,
        "lost": [f"{i}: {errors[i]}" for i in lost],
        "diverged": diverged,
        "seconds": round(time.monotonic() - started, 2),
        "chains": results,
        "ok": (
            not lost and not diverged
            and stats["migrations"] >= 1
            and migrations_out >= 1 and migrations_in >= 1
            and decode_picks >= streams
            and role_status.get("prefill", {}).get("ready") == 1
            and role_status.get("decode", {}).get("ready") == 1
            and not any(audit_failures.values())
            and pools_empty
        ),
    }
    if not summary["ok"]:
        raise AssertionError(
            f"serve disagg smoke failed: {json.dumps(summary)}"
        )
    return summary


def run_trace_smoke(
    seed: int = 0,
    max_new: int = 12,
    namespace: str = "tracez",
    cfg=None,
    device=None,
    params=None,
    block_size: int = 8,
) -> dict:
    """End-to-end proof of fleet-wide distributed tracing: a 1-prefill
    + 1-decode disaggregated fleet serves shared-prefix requests; at
    least one must migrate, and that request's merged trace — fetched
    through the observatory's /debug/tracez HTTP endpoint, i.e. the full
    collector path with clock handshakes — must contain every one of the
    8 hops exactly once, with monotone non-overlapping boundaries, ZERO
    orphan records, and a hop sum covering >= 95% of the client-measured
    TTFT. Also sanity-checks /debug/routez (decisions carry trace ids)
    and /debug/slozz (fleet quantiles present). Raises AssertionError on
    any violation. block_size: the replicas' KV block and prefill chunk
    (the shared prefix is two blocks)."""
    import urllib.request

    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate
    from ..telemetry.collector import HOP_NAMES
    from .observatory import make_observatory

    cfg, device, params = _smoke_setup(cfg, device, params)

    rng = random.Random(seed)
    streams = 2
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=2,
        namespace=namespace, block_size=block_size,
        prefill_chunk=block_size, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            preset="tiny", slots=2, weights_version="v1",
            replica_groups={
                "prefill": ServeReplicaGroup(replicas=1),
                "decode": ServeReplicaGroup(replicas=1),
            },
        )
    )
    svc.metadata.name = "tracez"
    svc.metadata.namespace = namespace

    shared = [
        rng.randrange(1, cfg.vocab_size) for _ in range(2 * block_size)
    ]
    prompts = [
        shared + [
            rng.randrange(1, cfg.vocab_size)
            for _ in range(rng.randint(1, 3))
        ]
        for _ in range(streams)
    ]

    started = time.monotonic()
    # per-stream: (trace_id, client-measured TTFT seconds)
    measured: List[Optional[dict]] = [None] * streams
    obs = None
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)

        for i, prompt in enumerate(prompts):
            t0 = time.monotonic()
            first_at = None
            final = None
            for event in router.generate_stream(
                prompt, max_new, corr=f"trace-{seed}-{i}", timeout=120.0,
            ):
                if first_at is None and event.get("token") is not None:
                    first_at = time.monotonic()
                if event.get("done"):
                    final = event
            measured[i] = {
                "trace": final.get("trace_id") if final else None,
                "client_ttft": (
                    first_at - t0 if first_at is not None else None
                ),
            }

        obs = make_observatory(router)
        obs_thread = threading.Thread(
            target=obs.serve_forever, daemon=True, name="observatory"
        )
        obs_thread.start()
        host, port = obs.server_address[:2]
        base = f"http://{host}:{port}"

        def get(path: str) -> dict:
            # trace-exempt: observatory debug fetches are reads about
            # traces, not members of one
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                return json.loads(resp.read())

        pages = {}
        for m in measured:
            if m and m["trace"]:
                pages[m["trace"]] = get(f"/debug/tracez?trace={m['trace']}")
        routez = get("/debug/routez")
        slozz = get("/debug/slozz")
        stats = router.stats()
    finally:
        if obs is not None:
            obs.shutdown()
            obs.server_close()
        fleet.stop()
        controller.stop()

    # the migrated request is the one whose merged trace decomposed
    # into the 8-hop disaggregated timeline
    migrated = {
        tid: page for tid, page in pages.items()
        if page["breakdown"]["mode"] == "disaggregated"
    }
    problems: List[str] = []
    if stats["migrations"] < 1:
        problems.append(f"no migrations (got {stats['migrations']})")
    if not migrated:
        problems.append("no trace decomposed as disaggregated")
    for tid, page in migrated.items():
        bd = page["breakdown"]
        names = [h["name"] for h in bd["hops"]]
        if names != list(HOP_NAMES):
            problems.append(f"{tid}: hops {names} != {list(HOP_NAMES)}")
        if bd["missing"]:
            problems.append(f"{tid}: missing boundaries {bd['missing']}")
        if page["orphans"]:
            ops = [r["fields"].get("op") for r in page["orphans"]]
            problems.append(f"{tid}: orphan records with ops {ops}")
        for prev, cur in zip(bd["hops"], bd["hops"][1:]):
            if cur["start_s"] != prev["end_s"]:
                problems.append(
                    f"{tid}: {cur['name']} start {cur['start_s']} != "
                    f"{prev['name']} end {prev['end_s']}"
                )
        if any(h["duration_s"] < 0 for h in bd["hops"]):
            problems.append(f"{tid}: negative hop duration")
        client_ttft = next(
            (m["client_ttft"] for m in measured if m["trace"] == tid),
            None,
        )
        hop_sum = sum(h["duration_s"] for h in bd["hops"])
        if client_ttft is None:
            problems.append(f"{tid}: no client TTFT measured")
        elif hop_sum < 0.95 * client_ttft:
            problems.append(
                f"{tid}: hops cover {hop_sum:.6f}s of client TTFT "
                f"{client_ttft:.6f}s (< 95%)"
            )
    traced_decisions = [
        d for d in routez.get("decisions", []) if d.get("trace")
    ]
    if not traced_decisions:
        problems.append("/debug/routez decisions carry no trace ids")
    if slozz["fleet"]["ttft"]["p95"] is None:
        problems.append("/debug/slozz fleet ttft p95 missing")

    summary = {
        "seed": seed,
        "streams": streams,
        "traces": sorted(pages),
        "migrated_traces": sorted(migrated),
        "breakdowns": {
            tid: page["breakdown"] for tid, page in pages.items()
        },
        "client_ttft": {
            m["trace"]: round(m["client_ttft"], 6)
            for m in measured if m and m["trace"]
        },
        "traced_decisions": len(traced_decisions),
        "problems": problems,
        "seconds": round(time.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(
            f"trace smoke failed: {json.dumps(summary)}"
        )
    return summary


def run_kv_observatory_smoke(
    seed: int = 0,
    max_new: int = 8,
    namespace: str = "kvobs",
    cfg=None,
    device=None,
    params=None,
) -> dict:
    """End-to-end proof of the fleet KV observatory: two paged monolithic
    replicas serve shared-preamble prompts with prefix-aware routing OFF,
    so the preamble gets prefilled — and cached — on both. Asserts the
    fleet prefix directory is non-empty with duplication factor > 1, the
    re-prefill waste counter moved (a stream was routed to a cold replica
    while a warm peer already held its prefix), every replica's /kv/statz
    page renders with resident digests covering its advertised /kv/digest
    set (no orphans), /healthz reports a clean pool audit, and the
    observatory's /debug/slozz carries the fleet "kv" block. Raises
    AssertionError on any violation."""
    import urllib.request

    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate
    from .observatory import fleet_kv_directory, make_observatory

    cfg, device, params = _smoke_setup(cfg, device, params)

    rng = random.Random(seed)
    block_size = 8
    substrate = InMemorySubstrate()
    # prefix_affinity=False is the point of the exercise: the router
    # still *sees* overlaps (decision ring, waste attribution) but
    # stops steering toward them, so duplication and re-prefill waste
    # become observable instead of being routed away
    router = LeastLoadedRouter(retry_wait=0.02, prefix_affinity=False)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=2,
        namespace=namespace, block_size=block_size,
        prefill_chunk=block_size, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            replicas=2, preset="tiny", slots=2, weights_version="v1",
        )
    )
    svc.metadata.name = "kvobs"
    svc.metadata.namespace = namespace

    shared = [
        rng.randrange(1, cfg.vocab_size) for _ in range(2 * block_size)
    ]

    def _tail() -> List[int]:
        return [
            rng.randrange(1, cfg.vocab_size)
            for _ in range(rng.randint(1, 3))
        ]

    started = time.monotonic()
    obs = None
    problems: List[str] = []
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)

        def _drain(prompt: List[int], corr: str,
                   first: Optional[threading.Event] = None) -> None:
            for event in router.generate_stream(
                prompt, max_new, corr=corr, timeout=120.0,
            ):
                if first is not None and event.get("token") is not None:
                    first.set()

        # wave 1: warm exactly one replica with the shared preamble,
        # then probe so the router's scraped digests know about it
        _drain(shared + _tail(), f"kvobs-{seed}-warm")
        router.probe()

        # wave 2: hold one stream in flight (it pins whichever replica
        # the load-only scorer picks), then route a second — least-
        # loaded forces it onto the *other* replica; one of the two is
        # cold while a warm peer advertises the preamble, so waste
        # attribution must fire for it
        first_token = threading.Event()
        pin_error: List[Optional[str]] = [None]

        def _pinned() -> None:
            try:
                _drain(shared + _tail(), f"kvobs-{seed}-pin", first_token)
            except Exception as err:  # noqa: BLE001 — asserted below
                pin_error[0] = f"{type(err).__name__}: {err}"

        pin = threading.Thread(target=_pinned, name="kvobs-pin")
        pin.start()
        if not first_token.wait(timeout=60.0):
            problems.append("pinned stream produced no token in 60s")
        _drain(shared + _tail(), f"kvobs-{seed}-spread")
        pin.join(timeout=120.0)
        if pin_error[0]:
            problems.append(f"pinned stream failed: {pin_error[0]}")

        # both replicas have now prefilled the preamble; re-probe so
        # the directory sees the duplication
        router.probe()
        kv_dir = fleet_kv_directory(router)
        stats = router.stats()
        digests = router.digests()
        statz = {
            name: client.kv_statz(top=5)
            for name, client in router.clients().items()
        }
        health = {
            name: client.healthy()
            for name, client in router.clients().items()
        }

        obs = make_observatory(router)
        obs_thread = threading.Thread(
            target=obs.serve_forever, daemon=True, name="observatory"
        )
        obs_thread.start()
        host, port = obs.server_address[:2]
        # trace-exempt: observatory debug fetches are reads about
        # streams, not members of one
        with urllib.request.urlopen(
            f"http://{host}:{port}/debug/slozz", timeout=30
        ) as resp:
            slozz = json.loads(resp.read())
    finally:
        if obs is not None:
            obs.shutdown()
            obs.server_close()
        fleet.stop()
        controller.stop()

    if not kv_dir["directory"]:
        problems.append("fleet prefix directory is empty")
    if kv_dir["duplication_factor"] <= 1.0:
        problems.append(
            "no duplication with prefix_affinity off (factor "
            f"{kv_dir['duplication_factor']})"
        )
    if not any(
        len(holders) >= 2 for holders in kv_dir["directory"].values()
    ):
        problems.append("no digest held by more than one replica")
    if stats["reprefill_waste_tokens"] <= 0:
        problems.append(
            "re-prefill waste counter did not move (tokens "
            f"{stats['reprefill_waste_tokens']}, events "
            f"{stats['reprefill_waste_events']})"
        )
    for name, page in statz.items():
        if not page.get("paged"):
            problems.append(f"{name}: /kv/statz reports paged=False")
            continue
        resident = set(page.get("resident_digests", []))
        if not resident:
            problems.append(f"{name}: /kv/statz has no resident digests")
        advertised = set(digests[name]["digest"])
        orphans = advertised - resident
        if orphans:
            problems.append(
                f"{name}: advertised digests absent from /kv/statz "
                f"residency: {sorted(orphans)}"
            )
        if not page.get("hot_prefixes"):
            problems.append(f"{name}: /kv/statz hot_prefixes is empty")
    for name, payload in health.items():
        if payload.get("pool_audit") != "ok":
            problems.append(
                f"{name}: /healthz pool_audit={payload.get('pool_audit')}"
                f" ({payload.get('pool_audit_error', '')})"
            )
    kv_block = slozz.get("kv")
    if not kv_block:
        problems.append("/debug/slozz has no kv block")
    elif kv_block["reprefill_waste_tokens_total"] <= 0:
        problems.append("/debug/slozz kv block shows zero waste")

    summary = {
        "seed": seed,
        "duplication_factor": kv_dir["duplication_factor"],
        "unique_blocks": kv_dir["unique_blocks"],
        "held_blocks": kv_dir["held_blocks"],
        "reprefill_waste_tokens": stats["reprefill_waste_tokens"],
        "reprefill_waste_events": stats["reprefill_waste_events"],
        "replicas": {
            name: {
                "split": page.get("split"),
                "resident": len(page.get("resident_digests", [])),
                "pool_audit": health[name].get("pool_audit"),
            }
            for name, page in statz.items()
        },
        "slozz_kv": kv_block,
        "problems": problems,
        "seconds": round(time.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(
            f"kv observatory smoke failed: {json.dumps(summary)}"
        )
    return summary


def _ttft_rule(slo_s: float):
    """The smokes' burn-rate rule on the router's TTFT series: the rule
    shape production uses (serve_replica_rules / fleet_rules), with
    windows of seconds instead of minutes so the whole arc fits a run."""
    from ..telemetry.alerts import BurnRateRule

    return BurnRateRule(
        "ttft-slo", "tf_operator_tpu_router_ttft_seconds", threshold_s=slo_s,
        windows=((2.0, 2.0), (6.0, 1.5)),
    )


def run_alert_smoke(
    seed: int = 0,
    max_new: int = 8,
    namespace: str = "alertz",
    slo_s: float = 0.25,
    delay_s: float = 0.4,
    cfg=None,
    device=None,
    params=None,
) -> dict:
    """End-to-end proof of the burn-rate alerting loop: boot a 2-replica
    fleet, run baseline traffic (nothing fires), inject FAULT_LATENCY
    through the chaos layer so every TTFT blows the SLO (the fast burn
    window must fire), then clear the fault and keep serving until the
    alert RESOLVES. The firing->resolved transitions must exist as
    kind="alert" flight records whose trace samples intersect the slowed
    requests' trace ids. Raises AssertionError on any violation."""
    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate
    from ..telemetry.alerts import AlertManager
    from ..telemetry.history import MetricHistory

    cfg, device, params = _smoke_setup(cfg, device, params)

    rng = random.Random(seed)
    flight = default_flight()
    fault_log = FaultLog(flight=flight, seed=seed)
    factory = LatencyClientFactory(fault_log=fault_log)
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(client_factory=factory, retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=2,
        namespace=namespace, fault_log=fault_log, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            replicas=2, preset="tiny", slots=2, weights_version="v1",
        )
    )
    svc.metadata.name = "alertz"
    svc.metadata.namespace = namespace

    fast_key, slow_key = "ttft-slo[2s]", "ttft-slo[6s]"
    history = MetricHistory(capacity=1024)
    history.track_registry(router.registry)
    manager = AlertManager(
        history, [_ttft_rule(slo_s)], registry=router.registry, flight=flight,
    )

    def drive(corr: str) -> Optional[str]:
        prompt = [
            rng.randrange(1, cfg.vocab_size)
            for _ in range(rng.randint(2, 5))
        ]
        final = None
        for event in router.generate_stream(
            prompt, max_new, corr=corr, timeout=120.0,
        ):
            if event.get("done"):
                final = event
        history.tick()
        manager.evaluate()
        return final.get("trace_id") if final else None

    started = time.monotonic()
    fired_during_baseline: List[str] = []
    slow_traces: List[str] = []
    fired: List[str] = []
    resolved = False
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(2)

        # phase 1 — baseline: in-SLO traffic, nothing may fire
        for i in range(6):
            drive(f"alert-base-{seed}-{i}")
        fired_during_baseline = list(manager.firing())

        # phase 2 — chaos: every request +delay_s TTFT until the fast
        # window fires (bounded; each request costs ~delay_s wall)
        factory.delay_s = delay_s
        deadline = time.monotonic() + 30.0
        i = 0
        while time.monotonic() < deadline:
            trace = drive(f"alert-slow-{seed}-{i}")
            if trace:
                slow_traces.append(trace)
            i += 1
            if fast_key in manager.firing():
                break
        fired = list(manager.firing())

        # phase 3 — recovery: fault off, healthy traffic until both
        # windows drain and every instance resolves
        factory.delay_s = 0.0
        deadline = time.monotonic() + 45.0
        i = 0
        while time.monotonic() < deadline:
            drive(f"alert-heal-{seed}-{i}")
            i += 1
            if not manager.firing():
                resolved = True
                break
            time.sleep(0.1)
    finally:
        fleet.stop()
        controller.stop()

    problems: List[str] = []
    if fired_during_baseline:
        problems.append(
            f"alerts fired on baseline traffic: {fired_during_baseline}"
        )
    if fast_key not in fired:
        problems.append(
            f"fast burn window never fired under chaos (firing={fired})"
        )
    if not resolved:
        problems.append(
            f"alert did not resolve after fault cleared "
            f"(still firing: {manager.firing()})"
        )
    if factory.injected < 1:
        problems.append("chaos layer injected no latency faults")
    if fault_log.counts().get(FAULT_LATENCY, 0) < 1:
        problems.append("no FAULT_LATENCY records in the fault log")

    # the alert flight records: at least one firing and one resolved
    # transition, trace-correlated with the requests that burned the
    # budget
    alert_records = [r.to_dict() for r in flight.snapshot(kind="alert")]
    states = {}
    for rec in alert_records:
        states.setdefault(rec["fields"].get("state"), []).append(rec)
    if not states.get("firing"):
        problems.append("no firing alert flight records")
    if not states.get("resolved"):
        problems.append("no resolved alert flight records")
    sampled = {
        t
        for rec in alert_records
        for t in str(rec["fields"].get("traces", "")).split(",")
        if t
    }
    if not sampled & set(slow_traces):
        problems.append(
            f"alert trace samples {sorted(sampled)[:4]} do not "
            f"intersect the slowed requests {slow_traces[:4]}"
        )

    summary = {
        "seed": seed,
        "fired": fired,
        "fast_window": fast_key,
        "slow_window": slow_key,
        "slow_window_fired": slow_key in fired,
        "resolved": resolved,
        "latency_faults": fault_log.counts().get(FAULT_LATENCY, 0),
        "slow_traces": slow_traces,
        "alert_records": len(alert_records),
        "problems": problems,
        "seconds": round(time.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(
            f"alert smoke failed: {json.dumps(summary)}"
        )
    return summary


def run_autoscale_smoke(
    seed: int = 0,
    max_new: int = 8,
    namespace: str = "autoscale",
    slo_s: float = 0.25,
    delay_s: float = 0.4,
    cooldown_s: float = 3.0,
    cfg=None,
    device=None,
    params=None,
    chain_check: Optional[Callable] = None,
    observe: bool = False,
    prompt_len=(2, 5),
) -> dict:
    """End-to-end proof of the closed scaling loop: a 1-replica decode
    group with a [1, 3] band and an enabled autoscale policy serves
    continuous traffic; chaos latency pushes TTFT out of SLO, the fast
    burn window fires, the ServeAutoscaler raises spec.replicas, the
    reconciler creates the pod, and the fleet boots it. The fault then
    clears, the slow window resolves, the cooldown passes, and the fleet
    scales back in — by drain, not kill. Asserts: scale-out AND scale-in
    both happened and are kind="scale" flight records (the out record
    trace-correlated with the requests that burned the budget), no two
    decisions for a role land closer than the cooldown (no oscillation),
    zero lost or diverged streams across the whole arc, and the group
    ends back at minReplicas. Raises AssertionError on any violation.

    chain_check as run_failover_soak's. observe: an observatory
    (make_observatory) over the router during the arc, scraped once the
    group has scaled out — /debug/slozz (the fleet SLO and its "kv" block,
    the fleet KV directory's figures), /debug/tracez of the newest stream
    served before the fault (a slowed one carries the fault's own chaos
    record, which the collector counts as an orphan) — with the pages' key
    figures in the summary ("observatory"). prompt_len: the prompts'
    lengths (inclusive); the KV directory lists full blocks only."""
    from ..api.types import ServeAutoscalePolicy
    from ..controller.serve import ServeServiceController
    from ..runtime import InMemorySubstrate
    from ..telemetry.alerts import AlertManager
    from ..telemetry.history import MetricHistory
    from .autoscaler import ServeAutoscaler

    cfg, device, params = _smoke_setup(cfg, device, params)
    check = chain_check or _exact

    rng = random.Random(seed)
    flight = default_flight()
    fault_log = FaultLog(flight=flight, seed=seed)
    factory = LatencyClientFactory(fault_log=fault_log)
    substrate = InMemorySubstrate()
    router = LeastLoadedRouter(client_factory=factory, retry_wait=0.02)
    fleet = InProcessFleet(
        substrate, router, cfg, {"v1": params}, slots=2,
        namespace=namespace, fault_log=fault_log, device=device,
    )
    controller = ServeServiceController(
        substrate, namespace=namespace,
        weight_update=fleet.update_weights,
    )
    svc = ServeService(
        spec=ServeServiceSpec(
            preset="tiny", slots=2, weights_version="v1",
            replica_groups={
                "decode": ServeReplicaGroup(
                    replicas=1, min_replicas=1, max_replicas=3,
                ),
            },
            # queue pressure is not under test here (the burn alert
            # is); park the queue trigger out of reach
            autoscale=ServeAutoscalePolicy(
                enabled=True, cooldown_seconds=cooldown_s,
                max_queue_per_replica=1e9,
            ),
        )
    )
    svc.metadata.name = "autoscale"
    svc.metadata.namespace = namespace

    fast_key = "ttft-slo[2s]"
    history = MetricHistory(capacity=1024)
    history.track_registry(router.registry)
    manager = AlertManager(
        history, [_ttft_rule(slo_s)], registry=router.registry, flight=flight,
    )
    autoscaler = ServeAutoscaler(
        substrate, namespace, "autoscale", manager, history,
        registry=router.registry, flight=flight, rule_name="ttft-slo",
    )

    # a small prompt family with precomputed inline greedy ground
    # truth; the load loop cycles through it so every completed stream
    # can be pinned to it
    low, high = prompt_len
    prompts = [
        [rng.randrange(1, cfg.vocab_size) for _ in range(rng.randint(low, high))]
        for _ in range(6)
    ]
    expected = inline_chains(cfg, params, prompts, max_new, device)

    stop_evt = threading.Event()
    out_lock = locks.make_lock("autoscale_smoke.outcomes")
    outcomes: List[dict] = []

    def load() -> None:
        # continuous load, one stream at a time: streams keep flowing
        # through the chaos window, the scale-out boot, and the
        # scale-in drain, so "zero lost streams" covers all of it
        k = 0
        while not stop_evt.is_set():
            i = k % len(prompts)
            slowed = factory.delay_s > 0
            rec = {
                "i": i, "chain": None, "error": None,
                "trace": None, "slowed": slowed,
            }
            try:
                final = None
                for event in router.generate_stream(
                    prompts[i], max_new,
                    corr=f"autoscale-{seed}-{k}", timeout=120.0,
                ):
                    if event.get("done"):
                        final = event
                if final is not None:
                    rec["chain"] = final["tokens"][0]
                    rec["trace"] = final.get("trace_id")
            except Exception as err:  # noqa: BLE001 — asserted below
                rec["error"] = f"{type(err).__name__}: {err}"
            with out_lock:
                outcomes.append(rec)
            k += 1
            time.sleep(0.01)

    # the flight ring is shared with every in-process replica (engine
    # admit/evict records etc.) and wraps well within the run, so the
    # scale records are accumulated per pump, not snapshotted at the end
    seen_scale: Dict[int, object] = {}

    def pump() -> None:
        # one observatory-shaped control step: refresh history,
        # evaluate alerts, let the autoscaler act, reconcile, sync,
        # and re-probe (the router only probes on demand; the real
        # deployment's observatory interval ticker covers this)
        history.tick()
        manager.evaluate()
        autoscaler.tick()
        controller.run_until_quiet()
        fleet.sync()
        router.probe()
        for rec in flight.snapshot(kind="scale"):
            seen_scale.setdefault(rec.seq, rec)

    def live_ready() -> int:
        return sum(
            1 for r in router.stats()["replicas"].values() if r["ready"]
        )

    started = time.monotonic()
    problems: List[str] = []
    baseline_scales = 0
    scaled_out = False
    scaled_in = False
    scaled_out_s = scaled_in_s = None
    observed: Optional[dict] = None
    obs = None
    load_t = threading.Thread(
        target=load, name="autoscale-load", daemon=True
    )
    try:
        substrate.create_serve_service(svc)
        controller.run_until_quiet()
        fleet.sync()
        fleet.wait_ready(1)
        if observe:
            from .observatory import make_observatory

            obs = make_observatory(router)
            threading.Thread(target=obs.serve_forever, daemon=True,
                             name="observatory").start()
        load_t.start()

        # phase 1 — baseline: in-SLO traffic, the autoscaler must
        # hold still
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            pump()
            time.sleep(0.1)
        baseline_scales = len(seen_scale)

        # phase 2 — ramp: every request +delay_s TTFT; the fast burn
        # window fires, the autoscaler scales out, the reconciler
        # creates the pod, the fleet boots it
        factory.delay_s = delay_s
        ramp = time.monotonic()
        deadline = ramp + 60.0
        while time.monotonic() < deadline:
            pump()
            if len(fleet.replica_names()) >= 2 and live_ready() >= 2:
                scaled_out = True
                scaled_out_s = time.monotonic() - ramp
                break
            time.sleep(0.05)
        if obs is not None and scaled_out:
            observed = _scrape_observatory(obs, outcomes, out_lock)

        # phase 3 — clear: fault off; the slow window resolves, the
        # cooldown passes, the autoscaler steps the group back to
        # minReplicas, and each departing replica drains out
        factory.delay_s = 0.0
        clear = time.monotonic()
        deadline = clear + 90.0
        while time.monotonic() < deadline:
            pump()
            if (
                len(fleet.replica_names()) == 1
                and not manager.firing()
            ):
                scaled_in = True
                scaled_in_s = time.monotonic() - clear
                break
            time.sleep(0.05)
    finally:
        stop_evt.set()
        load_t.join(timeout=120.0)
        if obs is not None:
            obs.shutdown()
            obs.server_close()
        fleet.stop()
        controller.stop()

    if baseline_scales:
        problems.append(
            f"{baseline_scales} scale decisions on baseline traffic"
        )
    if not scaled_out:
        problems.append("fleet never scaled out under chaos latency")
    if not scaled_in:
        problems.append(
            "fleet did not scale back to minReplicas after recovery"
        )
    if observe and observed is None:
        problems.append("the observatory was not scraped (no scale-out)")
    elif observed is not None:
        problems.extend(observed.pop("problems"))

    scale_records = [
        seen_scale[seq] for seq in sorted(seen_scale)
    ]
    outs = [
        r for r in scale_records
        if r.fields.get("direction") == "out"
    ]
    ins = [
        r for r in scale_records
        if r.fields.get("direction") == "in"
    ]
    if not outs:
        problems.append("no kind=scale direction=out flight records")
    if not ins:
        problems.append("no kind=scale direction=in flight records")
    if outs and not any(
        str(r.fields.get("reason", "")).startswith("burn:")
        for r in outs
    ):
        problems.append(
            "no scale-out decision attributed to the burn alert"
        )

    # no-oscillation: within a role, consecutive decisions must sit
    # at least a cooldown apart (each decision starts one) — so the
    # direction can change at most once per cooldown window
    by_role: Dict[str, List] = {}
    for rec in scale_records:
        by_role.setdefault(str(rec.fields.get("role")), []).append(rec)
    for role, recs in by_role.items():
        recs.sort(key=lambda r: r.t)
        for prev, cur in zip(recs, recs[1:]):
            gap = cur.t - prev.t
            if gap < cooldown_s * 0.95:
                problems.append(
                    f"{role}: decisions {gap:.2f}s apart "
                    f"(< cooldown {cooldown_s}s): thrash"
                )

    # the out record must carry the triggering alert's trace samples,
    # and they must intersect the requests slowed by the fault
    with out_lock:
        done = list(outcomes)
    slowed_traces = {
        rec["trace"] for rec in done if rec["slowed"] and rec["trace"]
    }
    out_traces = {
        t
        for rec in outs
        for t in str(rec.fields.get("traces", "")).split(",")
        if t
    }
    if outs and not (out_traces & slowed_traces):
        problems.append(
            f"scale-out trace samples {sorted(out_traces)[:4]} do not "
            f"intersect the slowed requests "
            f"{sorted(slowed_traces)[:4]}"
        )

    lost = [
        f"{i}: {rec['error']}" for i, rec in enumerate(done)
        if rec["chain"] is None
    ]
    verdicts = {
        i: check(prompts[rec["i"]], rec["chain"], expected[rec["i"]])
        for i, rec in enumerate(done) if rec["chain"] is not None
    }
    diverged = [i for i, why in verdicts.items() if why is not None]
    near_ties = [
        i for i, why in verdicts.items()
        if why is None and done[i]["chain"] != expected[done[i]["i"]]
    ]
    if lost:
        problems.append(f"lost streams: {lost}")
    if diverged:
        problems.append(f"diverged streams: {diverged}")
    if not done:
        problems.append("the load loop completed no streams")

    summary = {
        "seed": seed,
        "streams": len(done),
        "scale_out_records": len(outs),
        "scale_in_records": len(ins),
        "fast_window": fast_key,
        "autoscaler": autoscaler.describe(),
        "latency_faults": fault_log.counts().get(FAULT_LATENCY, 0),
        "scaled_out_s": scaled_out_s,
        "scaled_in_s": scaled_in_s,
        "boots": fleet.boots,
        "boot_log": [
            {"pod": b["pod"], "seconds": b["seconds"]} for b in fleet.boots_report()
        ],
        "captures": list(fleet.captures),
        "lost": lost,
        "diverged": diverged,
        "near_ties": near_ties,
        "observatory": observed,
        "problems": problems,
        "seconds": round(time.monotonic() - started, 2),
        "ok": not problems,
    }
    if not summary["ok"]:
        raise AssertionError(
            f"autoscale smoke failed: {json.dumps(summary, default=str)}"
        )
    return summary


def _scrape_observatory(obs, outcomes: List[dict], out_lock) -> dict:
    """One read of a running observatory's fleet pages: the fleet SLO
    with the KV directory's figures (/debug/slozz) and the merged trace
    of the newest stream completed before the latency fault
    (/debug/tracez). -> their key figures and the problems found
    ("problems")."""
    import urllib.request

    host, port = obs.server_address[:2]

    def get(path: str) -> dict:
        # trace-exempt: observatory reads are about streams, not of one
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as resp:
            return json.loads(resp.read())

    problems: List[str] = []
    slozz = get("/debug/slozz")
    kv = slozz.get("kv")
    with out_lock:
        traces = [r["trace"] for r in outcomes if not r["slowed"] and r["trace"]]
    tracez = get(f"/debug/tracez?trace={traces[-1]}") if traces else None
    if slozz["fleet"]["ttft"]["p95"] is None:
        problems.append("/debug/slozz: no fleet ttft p95")
    if slozz["fleet"]["replicas_scraped"] < 2:
        problems.append(f"/debug/slozz: {slozz['fleet']['replicas_scraped']} replicas scraped")
    if kv is None:
        problems.append("/debug/slozz: no kv block")
        kv = {}
    if tracez is None:
        problems.append("no trace from before the fault to fetch")
    else:
        if tracez["orphans"]:
            problems.append(f"/debug/tracez: orphans {tracez['orphans']}")
        if tracez["breakdown"]["missing"]:
            problems.append(f"/debug/tracez: missing {tracez['breakdown']['missing']}")
    return {
        "fleet_ttft": slozz["fleet"]["ttft"],
        "replicas_scraped": slozz["fleet"]["replicas_scraped"],
        "kv_duplication_factor": kv.get("duplication_factor"),
        "kv_unique_blocks": kv.get("unique_blocks"),
        "trace_mode": None if tracez is None else tracez["breakdown"]["mode"],
        "trace_hops": None if tracez is None else [
            h["name"] for h in tracez["breakdown"]["hops"]
        ],
        "problems": problems,
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.serve.fleet",
        description="ServeService fleet soaks (failover / disagg)",
    )
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--soak", action="store_true")
    mode.add_argument(
        "--disagg", action="store_true",
        help="disaggregated prefill/decode smoke: role-group "
        "ServeService, KV block-set migration, prefix-aware routing",
    )
    mode.add_argument(
        "--trace-smoke", action="store_true",
        help="distributed-tracing smoke: disagg fleet, migrated "
        "request, merged /debug/tracez timeline with all 8 hops",
    )
    mode.add_argument(
        "--alert-smoke", action="store_true",
        help="burn-rate alerting smoke: chaos latency pushes TTFT out "
        "of SLO, the fast burn window fires, the fault clears, the "
        "alert resolves — with trace-correlated alert flight records",
    )
    mode.add_argument(
        "--kv-observatory", action="store_true",
        help="fleet KV observatory smoke: two paged replicas, shared "
        "preamble, prefix affinity off — the prefix directory shows "
        "duplication > 1, the re-prefill waste counter moves, "
        "/kv/statz renders, and the pool audits stay clean",
    )
    mode.add_argument(
        "--autoscale-smoke", action="store_true",
        help="closed-loop autoscaling smoke: chaos latency trips the "
        "burn alert, the autoscaler scales the decode group out, the "
        "fault clears, the group drains back in — no oscillation, "
        "zero lost streams, trace-correlated kind=scale records",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--replicas", type=int, default=3)
    parser.add_argument("--streams", type=int, default=6)
    parser.add_argument("--kills", type=int, default=1)
    parser.add_argument("--max-new", type=int, default=12)
    parser.add_argument("--device", default=None,
                        help="where the replicas run: default cuda; cpu for the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    common = {"device": args.device}
    if args.disagg:
        summary = run_disagg_smoke(
            seed=args.seed, streams=min(args.streams, 4),
            max_new=args.max_new, **common,
        )
    elif args.trace_smoke:
        summary = run_trace_smoke(seed=args.seed, max_new=args.max_new, **common)
    elif args.kv_observatory:
        summary = run_kv_observatory_smoke(
            seed=args.seed, max_new=args.max_new, **common
        )
    elif args.alert_smoke:
        summary = run_alert_smoke(seed=args.seed, max_new=args.max_new, **common)
    elif args.autoscale_smoke:
        summary = run_autoscale_smoke(
            seed=args.seed, max_new=args.max_new, **common
        )
    else:
        summary = run_failover_soak(
            seed=args.seed, replicas=args.replicas, streams=args.streams,
            kills=args.kills, max_new=args.max_new, **common,
        )
    print(json.dumps(_short(summary), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
