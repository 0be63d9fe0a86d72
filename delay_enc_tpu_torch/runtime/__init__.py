"""The serving layer around the proving pipeline.

Counterpart of `delay_enc_tpu/runtime/`: the warm prover daemon
(`daemon.py`), which keeps SRS, keys, pair tables and the loaded kernels
resident on the card and serves proofs over a unix socket, its client
(`client.py`), and the benchmark's statements and key cache
(`workloads.py`).
"""

from .client import daemon_request, default_socket_path  # noqa: F401
