"""The resident serving tier: the `index serve` daemon and the `index
route` fleet router.

Counterpart of drep_tpu/serve: load once, batch concurrent classify
queries into one K x N rectangle against the sketch matrix held on the
device (a plain store) or against each consulted partition (a federated
root's streaming resident), hot-swap index generations between batches,
answer with the one-shot verdicts, drain on SIGTERM. The router speaks the
same protocol in front of N replicas of a federated root: scatter/gather
with generation fencing, hedged legs and PARTIAL verdicts on replica loss.
The wire is the JAX package's, so either package's client talks to either
package's daemon or router. See serve/daemon.py and serve/router.py. Not
ported yet: the fleet supervisor and the wire-chaos proxy (ROADMAP.md
queue 1, item 11c).
"""

from drep_tpu_torch.serve.batcher import AdmissionQueue, PendingRequest  # noqa: F401
from drep_tpu_torch.serve.client import ServeClient, ServeError  # noqa: F401
from drep_tpu_torch.serve.daemon import (  # noqa: F401
    IndexServer,
    ServeConfig,
    install_signal_handlers,
)
from drep_tpu_torch.serve.router import (  # noqa: F401
    ReplicaTable,
    RouterConfig,
    RouterServer,
)
