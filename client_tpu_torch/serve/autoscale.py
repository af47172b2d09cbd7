"""Elastic fleet autoscaler: the control loop between the fleet's
gossiped load signals and replica spawn/retire.

Counterpart of client_tpu/serve/autoscale.py, copied onto the port's
:class:`~client_tpu_torch.serve.Server` and
:class:`~client_tpu_torch.serve.fleet.FleetTier`.  The balance pool it
steers (``pressures()`` and ``update_endpoints(urls)``) is passed in:
the port's own :class:`~client_tpu_torch.balance.EndpointPool`, whose
health probes carry each replica's gossiped pressure and prefix
summary.

The fleet already *senses* load (``EndpointPool.pressures()`` — per-
replica queue depth, paged-KV occupancy and prefix-affinity pressure
gossiped on health probes) and already *actuates* safely (``drain()``
migrates live sequences, parked LM streams and hot cache/prefix content
to surviving peers; the anti-entropy push + probation ramp warm a new
replica before it takes full traffic).  This module is the loop in the
middle:

- **scale-up** when queue depth or KV occupancy crosses the policy's
  high watermark for ``up_after`` consecutive ticks: a new replica is
  spawned, joined to the peer mesh with the hottest survivor FIRST in
  its peer order (prefix-aware placement — its misses land on the
  replica most likely to hold the chains), warmed by one anti-entropy
  round from that survivor, and only then offered to the pool — where
  the probation + ramp-up machinery (not this module) gates its traffic
  share.
- **scale-down** when the whole fleet sits below the low watermark for
  ``down_after`` ticks: the lowest-pressure replica is RETIRED from the
  pool (immediately unroutable, in-flight finishes) and then drained —
  never killed — so nothing a client could notice is lost.
- **hysteresis + cooldown** keep a bursty diurnal ramp from flapping:
  watermark crossings must persist across ticks, and any action starts
  a cooldown window during which further decisions are suppressed (and
  counted: ``ctpu_autoscale_flap_suppressed_total``).

The loop never touches an engine or pool lock across a peer call: every
spawn/retire/warm runs on the autoscaler's own thread with only its own
bookkeeping lock held around list mutation.
"""

import threading
import time

from client_tpu_torch.serve.metrics import AUTOSCALE_HELP

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "ReplicaHandle",
    "ServerReplicaLauncher",
]


class AutoscalePolicy:
    """Watermarks, hysteresis and pacing for the control loop.

    ``scale_up_at`` / ``scale_down_at`` are per-replica queue-depth
    watermarks (the gossiped ``queue_depth`` pressure signal);
    ``kv_scale_up_at`` is the paged-KV occupancy fraction that forces a
    scale-up regardless of queue depth (block exhaustion is the
    earliest LM scale signal — admission backpressure hits before the
    queue looks deep).  ``up_after``/``down_after`` are consecutive-tick
    hysteresis floors, ``cooldown_s`` the post-action suppression
    window.
    """

    def __init__(self, min_replicas=1, max_replicas=4, scale_up_at=8.0,
                 scale_down_at=1.0, kv_scale_up_at=0.85, up_after=2,
                 down_after=3, cooldown_s=10.0, tick_interval_s=1.0):
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.scale_up_at = float(scale_up_at)
        self.scale_down_at = float(scale_down_at)
        if self.scale_down_at >= self.scale_up_at:
            raise ValueError(
                "scale_down_at must sit strictly below scale_up_at "
                f"({self.scale_down_at} >= {self.scale_up_at}) — equal "
                "watermarks oscillate on every tick"
            )
        self.kv_scale_up_at = float(kv_scale_up_at)
        self.up_after = max(int(up_after), 1)
        self.down_after = max(int(down_after), 1)
        self.cooldown_s = float(cooldown_s)
        self.tick_interval_s = float(tick_interval_s)


class ReplicaHandle:
    """One managed replica: the routable url plus (optionally) the
    in-process objects a launcher wants retire() to reach.  ``tier``
    (a :class:`~client_tpu_torch.serve.fleet.FleetTier`) enables peer-mesh
    wiring and anti-entropy warming; launchers managing out-of-process
    replicas may leave it None and do their own wiring."""

    def __init__(self, url, fleet_address=None, tier=None, server=None,
                 proxy=None):
        self.url = str(url)
        self.fleet_address = fleet_address
        self.tier = tier
        self.server = server
        self.proxy = proxy

    def __repr__(self):
        return f"ReplicaHandle({self.url!r}, fleet={self.fleet_address!r})"


class ServerReplicaLauncher:
    """Default launcher: in-process :class:`~client_tpu_torch.serve.Server`
    replicas, each with an attached started
    :class:`~client_tpu_torch.serve.fleet.FleetTier`.

    ``models_factory()`` builds a fresh model list per replica (model
    objects hold per-replica state and must not be shared); with a
    ``device`` (the launcher's: ``"cuda"`` or ``"cpu"``) it is called as
    ``models_factory(device=device)``, so every replica's models run
    there.  ``retire`` is the planned-exit path: the server drains
    (sequences, parked streams and hot content migrate through its
    still-wired tier), then the tier closes.
    """

    def __init__(self, models_factory, fleet_kwargs=None,
                 server_kwargs=None, drain_timeout_s=30.0, device=None):
        self.models_factory = models_factory
        self.fleet_kwargs = dict(fleet_kwargs or {})
        self.server_kwargs = dict(server_kwargs or {})
        self.drain_timeout_s = float(drain_timeout_s)
        self.device = device

    def spawn(self):
        from client_tpu_torch.serve import Server
        from client_tpu_torch.serve.fleet import FleetTier

        models = (self.models_factory() if self.device is None
                  else self.models_factory(device=self.device))
        tier = FleetTier(**self.fleet_kwargs).start()
        server = Server(
            models=models, with_default_models=False,
            fleet=tier, **self.server_kwargs,
        ).start()
        return ReplicaHandle(
            server.http_address, fleet_address=tier.address,
            tier=tier, server=server,
        )

    def retire(self, handle):
        # drain BEFORE closing the tier: the drain-time exports travel
        # through it to the surviving peers.  Flush the anti-entropy
        # queue synchronously after the drain — exports still queued
        # when the tier closes would die with it.
        if handle.server is not None:
            handle.server.drain(self.drain_timeout_s)
        if handle.tier is not None:
            try:
                handle.tier.replicate_now()
            except Exception:  # noqa: BLE001 - retire must finish
                pass
            handle.tier.close()


class Autoscaler:
    """The control loop.  Drive it synchronously (``tick()`` — tests and
    the bench own the clock) or via ``start()``/``close()`` (a daemon
    thread ticking every ``policy.tick_interval_s``) — one of the two at a
    time, never both: ticks are single-threaded by contract, so no lock
    is ever held across the spawn/retire/warm peer traffic a tick
    issues (the internal lock guards only the replica list and
    counters, for concurrent ``status()``/``replicas()`` readers)."""

    def __init__(self, pool, launcher, policy=None, registry=None):
        self.pool = pool
        self.launcher = launcher
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.registry = registry
        self._lock = threading.Lock()        # replica list + counters
        self._replicas = []
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.flap_suppressed = 0
        self._stop = threading.Event()
        self._thread = None

    # -- membership --------------------------------------------------------

    def adopt(self, handles):
        """Seed the managed set with already-running replicas (the
        fixture/CLI spawns the floor itself, the autoscaler steers from
        there).  Wires the peer mesh and publishes the membership to
        the pool."""
        with self._lock:
            self._replicas.extend(handles)
        self._wire_peers()
        self._publish_membership()
        self._gauge()
        return self

    def replicas(self):
        with self._lock:
            return list(self._replicas)

    # -- control loop ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        with self._lock:
            self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True,
        )
        self._thread.start()
        return self

    def close(self):
        """Stop the loop thread.  Managed replicas stay up — shutdown
        ownership belongs to whoever spawned the floor."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.policy.tick_interval_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                pass

    def tick(self, now=None):
        """One control decision.  Returns the action taken: ``"up"``,
        ``"down"``, ``"suppressed"`` (cooldown ate a triggered action)
        or None (steady state / hysteresis still filling)."""
        return self._tick(time.monotonic() if now is None else now)

    def _tick(self, now):
        policy = self.policy
        queue_max, kv_max, fresh = self._signals()
        over = fresh and (
            queue_max >= policy.scale_up_at
            or kv_max >= policy.kv_scale_up_at
        )
        under = fresh and (
            queue_max <= policy.scale_down_at
            and kv_max < policy.kv_scale_up_at
        )
        # decide under the lock (streaks/cooldown are status()-visible
        # state); act — spawn/retire peer traffic — strictly outside it
        with self._lock:
            n = len(self._replicas)
            self._up_streak = self._up_streak + 1 if over else 0
            self._down_streak = self._down_streak + 1 if under else 0
            want_up = (
                self._up_streak >= policy.up_after
                and n < policy.max_replicas
            )
            want_down = (
                self._down_streak >= policy.down_after
                and n > policy.min_replicas
            )
            if not want_up and not want_down:
                return None
            if (
                self._last_action_at is not None
                and now - self._last_action_at < policy.cooldown_s
            ):
                self.flap_suppressed += 1
                suppressed = True
            else:
                suppressed = False
                self._last_action_at = now
                if want_up:
                    self._up_streak = 0
                else:
                    self._down_streak = 0
        if suppressed:
            self._count("ctpu_autoscale_flap_suppressed_total")
            return "suppressed"
        if want_up:
            self._scale_up()
            return "up"
        self._scale_down(queue_key="queue_depth")
        return "down"

    def _signals(self):
        """(max queue depth, max KV fraction, any-fresh-signal) over the
        pool's freshness-filtered pressure view.  Stale/never-gossiped
        replicas read as no signal — a dead replica cannot steer the
        loop (see EndpointPool.pressures)."""
        queue_max, kv_max, fresh = 0.0, 0.0, False
        for pressure in self.pool.pressures().values():
            if not pressure:
                continue
            fresh = True
            queue_max = max(queue_max, float(pressure.get("queue_depth", 0)))
            kv_max = max(
                kv_max, float(pressure.get("kv_used_fraction", 0.0))
            )
        return queue_max, kv_max, fresh

    # -- actions -----------------------------------------------------------

    def _scale_up(self):
        handle = self.launcher.spawn()
        warm = self._warmest()
        with self._lock:
            self._replicas.append(handle)
            self.scale_ups += 1
        self._wire_peers(prefer=warm)
        # one anti-entropy round from the hottest survivor warms the new
        # replica's prefix/cache stores BEFORE the pool offers it
        # traffic (probation + ramp-up then pace the offered share)
        if warm is not None and warm.tier is not None:
            try:
                warm.tier.replicate_now()
            except Exception:  # noqa: BLE001 - warming is best-effort
                pass
        self._publish_membership()
        self._count("ctpu_autoscale_scale_ups_total")
        self._gauge()

    def _scale_down(self, queue_key="queue_depth"):
        pressures = self.pool.pressures()
        with self._lock:
            if len(self._replicas) <= self.policy.min_replicas:
                return
            # victim: lowest queued work; ties break toward the newest
            # replica (LIFO — the longest-lived replicas hold the most
            # affinity state)
            victim = min(
                reversed(self._replicas),
                key=lambda h: float(
                    (pressures.get(h.url) or {}).get(queue_key, 0)
                ),
            )
            self._replicas.remove(victim)
            self.scale_downs += 1
        # retire order matters: (1) the pool stops routing to the victim
        # (RETIRING: in-flight finishes, nothing new arrives), (2) the
        # victim — whose OWN peer list still names every survivor —
        # drains, migrating live sequences, parked streams and hot
        # content outward, (3) only THEN do survivors drop it from
        # their peer mesh.  Rewiring before the drain would sever the
        # live-pull path: a sticky sequence re-routed off the victim
        # mid-drain resumes via a survivor's peer lookup, which must
        # still be able to ask the victim for its live (never yet
        # pushed) sequence state.
        self._publish_membership()
        self.launcher.retire(victim)
        self._wire_peers()
        self._count("ctpu_autoscale_scale_downs_total")
        self._gauge()

    def _warmest(self):
        """The managed replica with the most prefix-affinity pressure —
        the anti-entropy warm source for a newcomer, and the head of its
        peer order (prefix-aware placement)."""
        pressures = self.pool.pressures()
        best, best_hot = None, -1.0
        for handle in self.replicas():
            hot = float(
                (pressures.get(handle.url) or {}).get("prefix_hot", 0)
            )
            if hot > best_hot:
                best, best_hot = handle, hot
        return best

    def _wire_peers(self, prefer=None):
        """Point every managed tier at every other replica's fleet
        address.  *prefer* (a handle) is placed FIRST in the others'
        peer lists — bounded-fan-out lookups try it before anyone else,
        which is what makes placement prefix-aware."""
        handles = self.replicas()
        addresses = {
            id(h): h.fleet_address
            for h in handles if h.fleet_address is not None
        }
        for handle in handles:
            if handle.tier is None:
                continue
            peers = [
                addr for hid, addr in addresses.items()
                if hid != id(handle)
            ]
            if prefer is not None and prefer is not handle:
                paddr = prefer.fleet_address
                if paddr in peers:
                    peers.remove(paddr)
                    peers.insert(0, paddr)
            handle.tier.set_peers(peers)

    def _publish_membership(self):
        urls = [h.url for h in self.replicas()]
        if urls:
            self.pool.update_endpoints(urls)

    # -- metrics / introspection -------------------------------------------

    def _count(self, name, value=1):
        if self.registry is not None:
            self.registry.inc(name, None, value=value,
                              help_=AUTOSCALE_HELP[name])

    def _gauge(self):
        if self.registry is not None:
            with self._lock:
                n = len(self._replicas)
            self.registry.set(
                "ctpu_autoscale_replicas", None, n,
                help_=AUTOSCALE_HELP["ctpu_autoscale_replicas"],
            )

    def status(self):
        with self._lock:
            return {
                "replicas": len(self._replicas),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "flap_suppressed": self.flap_suppressed,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
            }
