"""Host discovery (reference: horovod/runner/elastic/discovery.py). The
port's copy of ``horovod_tpu/runner/elastic/discovery.py``.

`HostDiscoveryScript` runs the user's script; its stdout is one
`host` or `host:slots` per line — the current available cluster. Polled
periodically by the ElasticDriver.
"""

import subprocess


class HostDiscovery:
    def find_available_hosts_and_slots(self):
        """→ dict {hostname: slots}."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    def __init__(self, hosts):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self):
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    def __init__(self, script, default_slots=1, timeout=10.0):
        self._script = script
        self._default_slots = default_slots
        self._timeout = timeout

    def find_available_hosts_and_slots(self):
        out = subprocess.run(
            self._script, shell=True, capture_output=True, text=True,
            timeout=self._timeout)
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed rc={out.returncode}: "
                f"{out.stderr.strip()}")
        hosts = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                hosts[host] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts
