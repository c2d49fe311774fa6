"""The incremental genome index on one store (counterpart of drep_tpu/index).

`build` snapshots a completed workdir, or bootstraps from FASTAs, as
generation 0; `update` admits K new genomes per batch — the K x N tail
rectangle on the Mash kernel (one launch a row stripe), dirty-component
re-clustering, the secondary of each touched primary cluster on the
fused indicator kernel — and atomically publishes the next generation;
`classify` answers membership queries from the store without writing it.
Stores are the JAX package's format, so either package reads, updates and
heals the other's.

Not ported yet: the federated index and its maintenance verbs (split,
merge, compact; ROADMAP.md queue 1 item 10b) and the serve tier with its
device-resident pack (item 11). A federated root raises
NotImplementedError.
"""

from drep_tpu_torch.index.build import build_from_paths, build_from_workdir  # noqa: F401
from drep_tpu_torch.index.classify import (  # noqa: F401
    SketchedQueries,
    classify_batch,
    index_classify,
    load_resident_index,
    sketch_queries,
)
from drep_tpu_torch.index.store import IndexStore, LoadedIndex, load_index  # noqa: F401
from drep_tpu_torch.index.update import index_update  # noqa: F401
