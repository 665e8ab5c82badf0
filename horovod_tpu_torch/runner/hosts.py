"""Host/slot parsing and rank assignment. The port's copy of
``horovod_tpu/runner/hosts.py``.

Reference parity: `horovod/runner/launch.py` (`parse_hosts` /
`parse_host_files`) and `horovod/runner/common/util/hosts.py`
(`get_host_assignments`): `-H a:4,b:2` → per-rank SlotInfo with
rank / local_rank / local_size / cross_rank / cross_size, ranks assigned
host-major (all of host 0's slots first) so intra-host rings stay
contiguous, so `data`-axis neighbours share a host wherever possible.
"""

import collections
import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


_HOST_RE = re.compile(r"^(?P<host>[\w.\-\[\]:]+?)(:(?P<slots>\d+))?$")


def parse_hosts(hosts_str):
    """Parse "host1:2,host2:4" (slots default 1) → [HostInfo]."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        m = _HOST_RE.match(part)
        if not m:
            raise ValueError(f"bad host spec: {part!r}")
        out.append(HostInfo(m.group("host"),
                            int(m.group("slots") or 1)))
    if not out:
        raise ValueError(f"no hosts in {hosts_str!r}")
    return out


def parse_hostfile(path):
    """Hostfile: one `host slots=N` (or `host:N`, or bare host) per line;
    '#' comments. (Reference: parse_host_files supports `host slots=N`.)"""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+?)(?::(\d+))?(?:\s+slots\s*=\s*(\d+))?$",
                         line)
            if not m:
                raise ValueError(f"bad hostfile line: {line!r}")
            slots = int(m.group(3) or m.group(2) or 1)
            hosts.append(HostInfo(m.group(1), slots))
    if not hosts:
        raise ValueError(f"hostfile {path} is empty")
    return hosts


def get_host_assignments(hosts, np_):
    """Assign np_ ranks to hosts, host-major. Returns [SlotInfo].

    Raises when the hosts cannot supply np_ slots (reference errors the
    same way before launching anything).
    """
    total = sum(h.slots for h in hosts)
    if np_ > total:
        raise ValueError(
            f"requested -np {np_} but hosts provide only {total} slots")
    cross_size = sum(
        1 for h in hosts if h.slots > 0 and _host_rank_base(hosts, h) < np_)
    slots = []
    rank = 0
    cross_rank = 0
    for h in hosts:
        if rank >= np_:
            break
        local_size = min(h.slots, np_ - rank)
        for lr in range(local_size):
            slots.append(SlotInfo(h.hostname, rank, np_, lr, local_size,
                                  cross_rank, cross_size))
            rank += 1
        cross_rank += 1
    return slots


def _host_rank_base(hosts, host):
    base = 0
    for h in hosts:
        if h is host:
            return base
        base += h.slots
    return base


def slots_by_host(slot_infos):
    by = collections.OrderedDict()
    for s in slot_infos:
        by.setdefault(s.hostname, []).append(s)
    return by


def is_local(hostname):
    return hostname in ("localhost", "127.0.0.1", "::1")


def refuse_remote(hostnames):
    """Raise for a host other than this one. The port launches on this
    host only: its workers meet in a store whose address the launcher
    (or the elastic driver) probes here, and a remote worker needs that
    address negotiated, with the remote spawn (ssh, LSF's blaunch),
    which are ROADMAP Queue A item 16."""
    remote = sorted({h for h in hostnames if not is_local(h)})
    if remote:
        raise NotImplementedError(
            f"remote hosts {remote}: the port launches on this host only; "
            f"multi-host launch is ROADMAP Queue A item 16")
