"""The resident serving tier: the `index serve` daemon over one index store.

Counterpart of drep_tpu/serve: load once, batch concurrent classify
queries into one K x N rectangle against the sketch matrix held on the
device, hot-swap index generations between batches, answer with the
one-shot verdicts, drain on SIGTERM. The wire is the JAX package's, so
either package's client talks to either package's daemon. See
serve/daemon.py. Not ported yet: the router, its supervisor and the wire
chaos harness (ROADMAP.md queue 1, item 11b).
"""

from drep_tpu_torch.serve.batcher import AdmissionQueue, PendingRequest  # noqa: F401
from drep_tpu_torch.serve.client import ServeClient, ServeError  # noqa: F401
from drep_tpu_torch.serve.daemon import (  # noqa: F401
    IndexServer,
    ServeConfig,
    install_signal_handlers,
)
