"""The incremental genome index (counterpart of drep_tpu/index).

`build` snapshots a completed workdir, or bootstraps from FASTAs, as
generation 0; `update` admits K new genomes per batch — the K x N tail
rectangle on the Mash kernel (one launch a row stripe), dirty-component
re-clustering, the secondary of each touched primary cluster on the
fused indicator kernel — and atomically publishes the next generation;
`classify` answers membership queries from the store without writing it.
Stores are the JAX package's format, so either package reads, updates and
heals the other's.

The federated index (index/federation.py, index/meta.py): `build
--partitions N` splits the genome space into range partitions, each a
full index store, under one atomically published meta-manifest; `update`
routes a batch by sketch-derived range code and runs one independent
update per dirty partition (in process or as `--fed_pods` subprocess
pods); only boundary LSH buckets cross partitions. `load_index`, and so
one-shot `classify`, reads a federated root as the assembled union; the
serve tier loads the streaming ``FederatedResident`` instead (the spine,
partitions' sketches on first consult, partition faults as PARTIAL
verdicts). The maintenance verbs (index/maintenance.py) split and merge
partitions and compact shard generations as staged transactions that
`roll_forward` converges.
"""

from drep_tpu_torch.index.build import build_from_paths, build_from_workdir  # noqa: F401
from drep_tpu_torch.index.classify import (  # noqa: F401
    SketchedQueries,
    classify_batch,
    index_classify,
    load_resident_index,
    sketch_queries,
)
from drep_tpu_torch.index.federation import (  # noqa: F401
    FederatedResident,
    FederationStore,
    build_federated,
    fed_update,
    load_federated,
    read_params_handoff,
    write_params_handoff,
)
from drep_tpu_torch.index.maintenance import (  # noqa: F401
    compact_store,
    fed_compact,
    fed_merge,
    fed_split,
    maintenance_snapshot,
    maintenance_targets_from_env,
    roll_forward,
)
from drep_tpu_torch.index.store import IndexStore, LoadedIndex, load_index  # noqa: F401
from drep_tpu_torch.index.update import index_update  # noqa: F401
