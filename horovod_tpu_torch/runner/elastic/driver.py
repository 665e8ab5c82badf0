"""ElasticDriver: membership monitoring, worker lifecycle, rendezvous epochs.
The port's copy of ``horovod_tpu/runner/elastic/driver.py``: the same
epochs, ranks, blacklist, spares, liveness and checkpoint tracking. Where
the reference hosts a ``jax.distributed`` coordination service per
epoch, this driver hosts a ``torch.distributed.TCPStore`` per epoch of
two or more workers, where the epoch's ranks build their process groups
(``distributed.py``, client mode); a store per epoch keeps one epoch's
keys from meeting the next's. It spawns on this host only: a remote host
is refused (``hosts.refuse_remote``; ROADMAP Queue A item 16c).

Queue-depth autoscale (``tpurun --serve-autoscale``), as the reference
has it: rank 0 of a serve loop publishes its load at
``/ctl/serve_load/<wid>`` on this driver's KV store
(``worker.report_serve_load``), whatever store the epoch's world meets
in; :meth:`ElasticDriver._check_serve_load` folds each sample through an
``AutoscalePolicy`` (``serving/autoscale.py``), and a new target caps
the active set of the next epoch, the workers it displaces parked as
spares. Beside the reference's stats the port keeps ``serve_loads``,
the samples consumed, and :func:`run_elastic` publishes the policy's
starting target in ``target_np`` (the reference's stays 0 until the
first resize).

Reference parity: `horovod/runner/elastic/driver.py` (`ElasticDriver`),
`registration.py`, `rendezvous.py`. The driver owns the HTTP KV store;
each membership change creates a new *epoch*: a fresh rank assignment
written to the KV store. Workers poll the epoch counter
(see `.worker`) and re-rendezvous. Hosts that keep failing are blacklisted
for a cooldown (reference blacklists forever by default; cooldown matches
its `--blacklist-cooldown-range` option).
"""

import json
import os
import time
import uuid

from .. import http_server, util
from ..hosts import HostInfo, get_host_assignments, refuse_remote
from ..local import find_free_port
from .discovery import FixedHosts, HostDiscoveryScript

DISCOVERY_INTERVAL_S = 1.0
FAILURE_WINDOW_S = 60.0
FAILURES_TO_BLACKLIST = 3
DEFAULT_COOLDOWN_RANGE = (10.0, 60.0)
WIND_DOWN_GRACE_S = 30.0
# Transient failures (driver-initiated evictions of wedged/partitioned
# workers — the elastic reset already absorbed them) age out of the
# blacklist window faster than hard crashes: one flaky switch port must
# not retire a 4-chip host for a full minute.
TRANSIENT_DECAY_S = 20.0


class _Worker:
    def __init__(self, worker_id, hostname, slot, proc, spawn_epoch):
        self.id = worker_id
        self.hostname = hostname
        self.slot = slot
        self.proc = proc
        self.spawn_epoch = spawn_epoch
        self.exit_code = None

    @property
    def alive(self):
        return self.exit_code is None and self.proc.poll() is None


class ElasticDriver:
    def __init__(self, command, discovery, min_np, max_np, extra_env=None,
                 verbose=False, cooldown_range=None, hot_spares=0):
        self.command = list(command)
        self.discovery = discovery
        self.min_np = min_np
        self.max_np = max_np
        self.extra_env = dict(extra_env or {})
        self.verbose = verbose
        self.cooldown_range = cooldown_range or DEFAULT_COOLDOWN_RANGE
        # Hot spares: extra workers kept rendezvoused-but-rankless so an
        # eviction is repaired by a rank assignment (incremental epoch)
        # instead of a cold spawn + import + rendezvous.
        self.hot_spares = int(hot_spares or 0)
        # Queue-depth autoscale (serving plane): an AutoscalePolicy fed
        # from /ctl/serve_load keys the loop's rank 0 publishes; while
        # set, _target_np caps the ACTIVE set of each epoch and excess
        # workers park as spares (scale-up headroom) instead of exiting.
        self.autoscale = None
        self._target_np = 0          # 0 = no autoscale cap
        # heartbeat_misses: workers whose liveness heartbeat went stale
        # (_check_liveness); workers publish it as
        # hvd_elastic_heartbeat_misses. serve_loads: load samples
        # consumed (_check_serve_load).
        self.stats = {"promotions": 0, "incremental_epochs": 0,
                      "full_epochs": 0, "driver_evictions": 0,
                      "autoscale_events": 0, "target_np": 0,
                      "heartbeat_misses": 0, "serve_loads": 0,
                      "last_ckpt_step": -1}
        self._spares = set()        # wids currently parked as hot spares
        self._active_ranks = {}     # wid -> rank in the CURRENT epoch
        self._rank_hosts = {}       # rank -> hostname in the CURRENT epoch
        self._evict_handled = set()  # (victim wid, epoch) pushes consumed
        self._driver_killed = set()  # wids WE killed (failure pre-recorded)
        self._alive_seen = {}       # wid -> (last seq bytes, ts it changed)
        try:
            self._peer_timeout_ms = int(self.extra_env.get(
                "HVD_PEER_TIMEOUT_MS",
                os.environ.get("HVD_PEER_TIMEOUT_MS", "0")))
        except ValueError:
            self._peer_timeout_ms = 0
        # Per-job HMAC secret: the KV store binds 0.0.0.0, so without
        # signatures anyone on the network could PUT /ctl/epoch and resize
        # or kill the job (reference: runner/common/util/secret.py tokens on
        # every BasicService message). Workers receive it via the spawn env.
        self.secret = util.make_secret_key()
        self.rdv = http_server.RendezvousServer(secret_key=self.secret,
                                                addr="0.0.0.0")
        self.rdv_port = self.rdv.start()
        self.epoch = -1
        self.workers = {}            # id -> _Worker
        self._host_failures = {}     # host -> [timestamps]
        self._blacklist_until = {}   # host -> ts
        self._excluded = set()       # worker ids told to exit (not successes)
        self._reset_handled = set()  # (worker_id, epoch) reset requests seen
        self._success_seen = False
        self._success_spawn_max = -1
        self._wind_down_failed = False
        self._wind_down_since = None
        # Per-epoch stores (driver-hosted so a worker death can never take
        # the meeting point down — see distributed.py). Only the previous
        # epoch's store is kept beside the current one: its clients may
        # still be leaving it.
        self._stores = []

    # -- lifecycle --------------------------------------------------------

    def _log(self, msg):
        if self.verbose:
            print(f"[elastic-driver] {msg}", flush=True)

    def _spawn(self, hostname, slot):
        wid = f"{hostname}-{slot}-{uuid.uuid4().hex[:8]}"
        env = dict(os.environ)
        env.update(self.extra_env)
        env["HVD_ELASTIC"] = "1"
        env["HVD_RENDEZVOUS_ADDR"] = f"127.0.0.1:{self.rdv_port}"
        env["HVD_RENDEZVOUS_SECRET"] = self.secret.hex()
        env["HVD_WORKER_ID"] = wid
        # The first epoch that can possibly include this worker: wait for it
        # instead of latching onto a stale current epoch whose assignment
        # table will never contain this id.
        env["HVD_SPAWN_EPOCH"] = str(self.epoch + 1)
        proc = util.safe_exec(self.command, env=env)
        w = _Worker(wid, hostname, slot, proc, self.epoch + 1)
        self.workers[wid] = w
        self._log(f"spawned {wid}")
        return w

    def _live_failures(self, host, now):
        """Failure records still inside their window: transient ones
        (driver evictions of wedged workers) decay after TRANSIENT_DECAY_S,
        hard crashes after FAILURE_WINDOW_S."""
        return [(t, tr) for (t, tr) in self._host_failures.get(host, [])
                if now - t < (TRANSIENT_DECAY_S if tr else FAILURE_WINDOW_S)]

    def _blacklisted(self, host, now):
        if self._blacklist_until.get(host, 0) <= now:
            return False
        # Decay: a blacklist earned ENTIRELY by transient evictions lifts
        # early once those records age out — the stall that triggered them
        # was a one-off (GC pause, transient partition), not a bad host.
        # Any hard crash in the mix pins the full cooldown.
        fails = self._host_failures.get(host, [])
        live = self._live_failures(host, now)
        if all(tr for _, tr in fails) and len(live) < FAILURES_TO_BLACKLIST:
            self._blacklist_until.pop(host, None)
            self._host_failures[host] = live
            self._log(f"blacklist on {host} decayed (transient failures "
                      f"aged out)")
            return False
        return True

    def _record_failure(self, host, transient=False, now=None):
        now = time.time() if now is None else now
        lst = self._live_failures(host, now)
        lst.append((now, transient))
        self._host_failures[host] = lst
        if len(lst) >= FAILURES_TO_BLACKLIST:
            lo, hi = self.cooldown_range
            cooldown = min(hi, max(lo, lo * (2 ** (len(lst) -
                                                   FAILURES_TO_BLACKLIST))))
            self._blacklist_until[host] = now + cooldown
            self._log(f"blacklisting {host} for {cooldown:.0f}s")

    # -- epochs -----------------------------------------------------------

    def _new_epoch(self, desired=None):
        """Publish a new rank assignment. Workers on hosts no longer in
        `desired` membership (scale-down / blacklist) get the "exit"
        directive — unless dropping them would go below min_np."""
        self.epoch += 1
        alive = sorted((w for w in self.workers.values() if w.alive),
                       key=lambda w: (w.spawn_epoch, w.hostname, w.slot))
        active, extra = [], []
        per_host = {}
        cap = self.max_np or float("inf")
        if self._target_np:
            # Autoscale: the policy's target bounds the active set (never
            # below min_np); the workers it displaces stay alive as
            # spares, so the next scale-up is an incremental epoch.
            cap = min(cap, max(self._target_np, self.min_np))
        for w in alive:
            n = per_host.get(w.hostname, 0)
            host_cap = desired.get(w.hostname, 0) if desired is not None \
                else float("inf")
            if n < host_cap and len(active) < cap:
                active.append(w)
                per_host[w.hostname] = n + 1
            else:
                extra.append(w)
        if len(active) < self.min_np and extra:
            # keep excess workers rather than dropping below min_np
            keep = extra[:self.min_np - len(active)]
            active += keep
            extra = extra[len(keep):]

        # Hot spares: park up to hot_spares of the excess — rendezvoused,
        # heartbeating, rankless — instead of telling them to exit. Under
        # autoscale ALL excess parks: exiting a scaled-down worker would
        # just respawn it next loop (the host is still desired), and the
        # whole point of scaling down the ACTIVE set while keeping the
        # processes warm is that scale-up costs one incremental epoch.
        n_spares = len(extra) if self.autoscale is not None \
            else self.hot_spares
        spares = extra[:n_spares]
        extra = extra[n_spares:]

        promoted = [w for w in active if w.id in self._spares]
        prev = self._active_ranks
        ordered = self._incremental_order(active, prev)
        if ordered is not None:
            self.stats["incremental_epochs"] += 1
        else:
            # Full re-rank: host-major over the active workers.
            by_host = {}
            for w in active:
                by_host.setdefault(w.hostname, []).append(w)
            ordered = [w for ws in by_host.values() for w in ws]
            if prev:
                self.stats["full_epochs"] += 1
        self.stats["promotions"] += len(promoted)
        # HostInfo from the contiguous hostname runs of `ordered` (for the
        # full path this equals the by_host grouping; the incremental path
        # guaranteed contiguity before returning an order).
        hosts = []
        for w in ordered:
            if hosts and hosts[-1].hostname == w.hostname:
                hosts[-1] = HostInfo(w.hostname, hosts[-1].slots + 1)
            else:
                hosts.append(HostInfo(w.hostname, 1))
        slots = get_host_assignments(hosts, len(active))

        jax_coord = self._serve_store(len(active))
        for w, s in zip(ordered, slots):
            a = {"rank": s.rank, "size": s.size,
                 "local_rank": s.local_rank, "local_size": s.local_size,
                 "cross_rank": s.cross_rank, "cross_size": s.cross_size,
                 "jax_coord": jax_coord}
            if self.stats["last_ckpt_step"] >= 0:
                a["ckpt_step"] = self.stats["last_ckpt_step"]
            self.rdv.put(f"/assign-{self.epoch}/{w.id}",
                         json.dumps(a).encode())
        for w in spares:
            self.rdv.put(f"/assign-{self.epoch}/{w.id}",
                         json.dumps({"spare": True}).encode())
        for w in extra:
            self._excluded.add(w.id)
            self.rdv.put(f"/assign-{self.epoch}/{w.id}", b"exit")
        self._spares = {w.id for w in spares}
        self._active_ranks = {w.id: s.rank for w, s in zip(ordered, slots)}
        self._rank_hosts = {s.rank: w.hostname
                            for w, s in zip(ordered, slots)}
        self.rdv.put("/ctl/epoch", str(self.epoch).encode())
        self._publish_stats()
        # Reset requests for epochs before this one are resolved by it.
        self._reset_handled = {(w, e) for (w, e) in self._reset_handled
                               if e >= self.epoch}
        self._log(f"epoch {self.epoch}: {len(active)} active "
                  f"({[w.id for w in active]}), {len(spares)} spare"
                  f"{' (' + str(len(promoted)) + ' promoted)' if promoted else ''}")

    def _incremental_order(self, active, prev):
        """Order `active` so the host-major rank assignment hands every
        survivor its previous rank; newcomers (promoted spares / fresh
        spawns) slot into the freed ranks, preferring the evicted
        occupant's host. None when impossible — the size changed, a
        survivor was not in the previous epoch, or the resulting hostname
        sequence is not host-contiguous (ranks must stay host-major for
        local_rank/cross_rank to mean anything)."""
        if not prev or len(active) != len(prev):
            return None
        survivors = [w for w in active if w.id in prev]
        fresh = sorted((w for w in active if w.id not in prev),
                       key=lambda w: (w.hostname, w.slot))
        if not survivors:
            return None  # nothing incremental about a full re-rank
        order = [None] * len(active)
        for w in survivors:
            order[prev[w.id]] = w
        for i in (i for i, w in enumerate(order) if w is None):
            want = self._rank_hosts.get(i)
            pick = next((w for w in fresh if w.hostname == want),
                        fresh[0] if fresh else None)
            if pick is None:
                return None
            fresh.remove(pick)
            order[i] = pick
        # Host-major validity: each hostname must form ONE contiguous run.
        seen, last = set(), None
        for w in order:
            if w.hostname != last:
                if w.hostname in seen:
                    return None
                seen.add(w.hostname)
                last = w.hostname
        return order

    def _check_ckpt_commits(self):
        """Consume /ctl/ckpt commit reports (pushed by the checkpoint set
        root after every durable commit — checkpoint._report_commit) and
        track the newest committed step. It is republished in
        /ctl/elastic_stats (→ hvd.elastic_stats()['last_ckpt_step']) and
        rides every subsequent epoch's assignments, so a promoted spare
        restores via the manifest path without a collective."""
        newest = self.stats["last_ckpt_step"]
        for path, val in self.rdv.scan("/ctl/ckpt/").items():
            self.rdv.delete(path)  # consume: keep the KV bounded
            try:
                newest = max(newest, int(val.decode()))
            except ValueError:
                continue
        if newest != self.stats["last_ckpt_step"]:
            self.stats["last_ckpt_step"] = newest
            self._log(f"checkpoint committed @ step {newest}")
            self._publish_stats()

    def _check_serve_load(self):
        """Consume /ctl/serve_load observations (published by the serve
        loop's rank 0 — worker.report_serve_load) and fold them through
        the autoscale policy. Returns True when the target changed and
        the epoch must be republished."""
        dirty = seen = False
        for path, val in self.rdv.scan("/ctl/serve_load").items():
            self.rdv.delete(path)  # consume: keep the KV bounded
            try:
                load = json.loads(val.decode())
                depth = int(load["queue_depth"])
                fill = float(load.get("batch_fill", 1.0))
            except (ValueError, KeyError, TypeError):
                continue
            self.stats["serve_loads"] += 1
            seen = True
            target = self.autoscale.observe(depth, fill)
            if target is not None and target != self._target_np:
                self._log(f"autoscale: target_np -> {target} "
                          f"(queue_depth={depth}, batch_fill={fill:.2f})")
                self._target_np = target
                self.stats["autoscale_events"] += 1
                self.stats["target_np"] = target
                dirty = True
        if seen:
            self._publish_stats()
        return dirty

    def _publish_stats(self):
        """Publish the driver-side elastic counters to the KV store;
        workers fold them into hvd.elastic_stats()."""
        self.rdv.put("/ctl/elastic_stats", json.dumps(self.stats).encode())

    def _kill_worker(self, w, transient):
        """SIGKILL a wedged/partitioned worker and pre-record its failure
        (the reap loop skips _driver_killed to avoid double-counting)."""
        self.stats["driver_evictions"] += 1
        self._driver_killed.add(w.id)
        try:
            w.proc.kill()
        except Exception:
            pass
        self._record_failure(w.hostname, transient=transient)
        self._publish_stats()

    def _check_liveness(self, now):
        """Scan the workers' KV alive-sequences. A value that has not
        CHANGED (driver-clock comparison only — no cross-host clocks) for
        longer than the stale window means the process is wedged
        (SIGSTOP) or partitioned from the KV store; kill it so the epoch
        can be repaired. Returns True when membership changed."""
        stale_s = max(5.0, self._peer_timeout_ms / 1000.0 * 10)
        dirty = False
        for path, val in self.rdv.scan("/ctl/alive/").items():
            wid = path.rsplit("/", 1)[-1]
            prev = self._alive_seen.get(wid)
            if prev is None or prev[0] != val:
                self._alive_seen[wid] = (val, now)
                continue
            w = self.workers.get(wid)
            if w is None or not w.alive or wid in self._driver_killed:
                continue
            if now - prev[1] > stale_s:
                self._log(f"{wid} liveness stale {now - prev[1]:.1f}s "
                          f"(> {stale_s:.1f}s); killing (wedged or "
                          f"partitioned)")
                self.stats["heartbeat_misses"] += 1
                self._kill_worker(w, transient=True)
                dirty = True
        return dirty

    def _serve_store(self, np_):
        """Host this epoch's ``TCPStore`` in the driver (``is_master``, not
        waiting for its clients: every rank joins as a client). Returns its
        address for the assignment's ``jax_coord`` (the reference's key;
        workers export it as ``HVD_JAX_COORD_ADDR``), or None for an epoch
        of one worker, whose world meets in a ``HashStore``. The port is
        driver-local, so it is genuinely probeable."""
        if np_ < 2:
            return None
        import datetime

        import torch.distributed as dist

        port = find_free_port()
        timeout = int(os.environ.get("HVD_JAX_COORD_TIMEOUT", "120"))
        store = dist.TCPStore("0.0.0.0", port, None, True,
                              timeout=datetime.timedelta(seconds=timeout),
                              wait_for_workers=False)
        # Retain only the PREVIOUS epoch's store (its clients may still be
        # leaving); dropping an older one stops its server.
        self._stores = self._stores[-1:] + [store]
        addr = f"127.0.0.1:{port}"
        self._log(f"epoch {self.epoch}: store on {addr}")
        return addr

    # -- main loop --------------------------------------------------------

    def run(self):
        """Blocks until the job finishes; returns exit code."""
        last_discovery = 0.0
        desired = {}
        membership_dirty = True
        while True:
            now = time.time()
            if now - last_discovery >= DISCOVERY_INTERVAL_S:
                last_discovery = now
                try:
                    found = self.discovery.find_available_hosts_and_slots()
                except Exception as e:
                    self._log(f"discovery failed: {e}")
                    found = desired
                refuse_remote(found)
                found = {h: s for h, s in found.items()
                         if not self._blacklisted(h, now)}
                if found != desired:
                    desired = found
                    membership_dirty = True

            # Worker-pushed reset requests (reference:
            # runner/elastic/worker.py WorkerNotificationService): a worker
            # that hit HorovodInternalError while every process is still
            # alive needs a NEW epoch to re-rendezvous into — without the
            # push it would stall toward the 600 s rendezvous timeout.
            for path, val in self.rdv.scan("/ctl/reset/").items():
                wid = path.rsplit("/", 1)[-1]
                self.rdv.delete(path)  # consume: keep the KV bounded
                try:
                    req_epoch = int(val.decode())
                except ValueError:
                    continue
                key = (wid, req_epoch)
                if req_epoch >= self.epoch and key not in self._reset_handled:
                    self._reset_handled.add(key)
                    self._log(f"reset requested by {wid} (epoch {req_epoch})")
                    membership_dirty = True

            # Checkpoint-commit reports feed last_ckpt_step (state plane).
            self._check_ckpt_commits()

            if not self._success_seen:
                # Worker-pushed evictions: a surviving peer caught
                # RankEvictedError naming a wedged rank. SIGKILL the victim
                # (a SIGSTOP'd process never exits on its own; SIGTERM
                # stays pending while it is stopped) and let the respawn /
                # spare-promotion path repair the epoch.
                for path, val in self.rdv.scan("/ctl/evict/").items():
                    self.rdv.delete(path)  # consume: keep the KV bounded
                    try:
                        req = json.loads(val.decode())
                        rank, ep = int(req["rank"]), int(req["epoch"])
                    except (ValueError, KeyError, TypeError):
                        continue
                    if ep != self.epoch:
                        continue  # stale: that epoch's mesh is gone
                    vid = next((w for w, r in self._active_ranks.items()
                                if r == rank), None)
                    if vid is None or (vid, ep) in self._evict_handled:
                        continue
                    self._evict_handled.add((vid, ep))
                    w = self.workers.get(vid)
                    if w is not None and w.alive:
                        self._log(f"evicting {vid} (rank {rank}, epoch "
                                  f"{ep}): named by a surviving peer")
                        self._kill_worker(w, transient=True)
                        membership_dirty = True

                # Liveness backstop: a wedge that strikes MID-COLLECTIVE
                # never misses a control-plane heartbeat (the coordinator
                # is not gathering), but the worker's KV alive-sequence
                # stops advancing — kill it here.
                if self._peer_timeout_ms > 0:
                    membership_dirty |= self._check_liveness(now)

                # Serving-plane load reports drive the autoscale target.
                if self.autoscale is not None:
                    membership_dirty |= self._check_serve_load()

            # reap exits
            for w in list(self.workers.values()):
                if w.exit_code is None:
                    code = w.proc.poll()
                    if code is not None:
                        w.exit_code = code
                        if code == 0:
                            if w.id in self._excluded:
                                self._log(f"{w.id} exited (excluded)")
                            else:
                                self._success_seen = True
                                self._success_spawn_max = max(
                                    self._success_spawn_max, w.spawn_epoch)
                                self._log(f"{w.id} finished OK")
                        elif (self._success_seen and
                              w.spawn_epoch > self._success_spawn_max):
                            # Collateral: a worker spawned AFTER every
                            # finisher (late joiner) failing while the job
                            # winds down — typically init against a rank 0
                            # that already left. It never carried training
                            # state, so it cannot invalidate the result.
                            self._log(f"late joiner {w.id} exited rc={code} "
                                      f"during wind-down (ignored)")
                        else:
                            self._log(f"{w.id} FAILED rc={code}")
                            if w.id not in self._driver_killed:
                                # Driver-initiated kills already recorded
                                # a transient failure at kill time.
                                self._record_failure(w.hostname)
                            if self._success_seen:
                                # An ESTABLISHED peer failing after a
                                # finisher: its collective work completed
                                # (lockstep), but rank-local post-work
                                # (final artifact writes) may not have —
                                # surface it.
                                self._wind_down_failed = True
                            membership_dirty = True

            alive = [w for w in self.workers.values() if w.alive]

            if self._success_seen:
                # Winding down: no respawns. Tell workers still waiting in
                # rendezvous to exit (they'd otherwise sit out the 600 s
                # assignment timeout). ESTABLISHED workers get unbounded
                # time (legitimate tail work: final eval, rank-0 artifact
                # writes); only late joiners — which never trained — are
                # terminated after a grace period.
                if not alive:
                    return 1 if self._wind_down_failed else 0
                if self._wind_down_since is None:
                    self._wind_down_since = now
                    self.epoch += 1
                    for w in alive:
                        self._excluded.add(w.id)
                        self.rdv.put(f"/assign-{self.epoch}/{w.id}", b"exit")
                    self.rdv.put("/ctl/epoch", str(self.epoch).encode())
                elif now - self._wind_down_since > WIND_DOWN_GRACE_S:
                    for w in alive:
                        if w.spawn_epoch > self._success_spawn_max:
                            self._log(f"terminating late joiner {w.id}")
                            util.terminate(w.proc)
                time.sleep(0.1)
                continue

            # spawn to match desired membership (up to max_np)
            if membership_dirty:
                have = {}
                for w in alive:
                    have[w.hostname] = have.get(w.hostname, 0) + 1
                total = sum(have.values())
                # Spawn budget covers the spare pool too, so a promotion
                # is followed by a background respawn that refills it.
                cap = (self.max_np + self.hot_spares) if self.max_np \
                    else float("inf")
                spawned = False
                for host, slots in desired.items():
                    for slot in range(have.get(host, 0), slots):
                        if total >= cap:
                            break
                        if self._blacklisted(host, now):
                            continue
                        self._spawn(host, slot)
                        total += 1
                        spawned = True
                alive = [w for w in self.workers.values() if w.alive]
                if len(alive) < self.min_np:
                    if not desired or all(
                            self._blacklisted(h, now) for h in desired):
                        self._log(
                            f"only {len(alive)} alive < min_np "
                            f"{self.min_np} and no usable hosts; failing")
                        self.stop()
                        return 1
                    # wait for discovery/cooldown to supply hosts
                    time.sleep(0.2)
                    continue
                self._new_epoch(desired)
                membership_dirty = False

            if not alive and not self._success_seen:
                self._log("all workers dead; failing")
                return 1
            time.sleep(0.05)

    def stop(self):
        for w in self.workers.values():
            if w.alive:
                util.terminate(w.proc)
        self.rdv.stop()
        self._stores = []


def run_elastic(args):
    """Entry from `tpurun --min-np/--max-np/--host-discovery-script`."""
    from ..config_parser import args_to_env
    from ..hosts import parse_hosts

    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script)
    elif args.hosts:
        discovery = FixedHosts({h.hostname: h.slots
                                for h in parse_hosts(args.hosts)})
    else:
        discovery = FixedHosts({"localhost": args.np or 1})
    min_np = args.min_np or args.np or 1
    max_np = args.max_np or 0
    hot_spares = getattr(args, "hot_spares", 0) or 0
    if hot_spares and not max_np:
        # Spares only exist as workers beyond the active cap; an uncapped
        # job would absorb them into the active set. Default the cap to
        # the requested size.
        max_np = args.np or min_np
    extra_env = args_to_env(args)
    driver = ElasticDriver(args.command, discovery, min_np, max_np,
                           extra_env=extra_env, verbose=args.verbose,
                           cooldown_range=tuple(
                               args.blacklist_cooldown_range)
                           if args.blacklist_cooldown_range else None,
                           hot_spares=hot_spares)
    if (getattr(args, "serve_autoscale", None)
            or os.environ.get("HVD_SERVE_AUTOSCALE") == "1"):
        # The serve loop's rank 0 publishes load to /ctl/serve_load; the
        # policy resizes the active set between min_np and max_np.
        from ...serving.autoscale import AutoscalePolicy

        high = getattr(args, "serve_autoscale_high", None)
        if high is None:
            try:
                high = int(os.environ.get("HVD_SERVE_AUTOSCALE_HIGH",
                                          "0")) or None
            except ValueError:
                high = None
        kw = {} if high is None else {"high_depth": high}
        driver.autoscale = AutoscalePolicy(
            min_np, max_np or max(min_np, args.np or min_np), **kw)
        driver.stats["target_np"] = driver.autoscale.target
    try:
        return driver.run()
    finally:
        driver.stop()

