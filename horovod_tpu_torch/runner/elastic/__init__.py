"""Elastic launcher machinery (reference: horovod/runner/elastic/): the
port's copy of ``horovod_tpu/runner/elastic/``.

- :mod:`.discovery` — host discovery (user script → {host: slots}).
- :mod:`.driver` — ElasticDriver: membership monitoring, worker lifecycle,
  blacklisting, epoch-based rendezvous over the HTTP KV store.
- :mod:`.worker` — worker-side rendezvous client + host-update
  notification polling.
"""
