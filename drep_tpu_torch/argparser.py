"""CLI argument tree: `compare`, `dereplicate`, `index` and `check_dependencies`.

Counterpart of drep_tpu/argparser.py. The flag groups, names and defaults
of `compare` and `dereplicate` are the JAX package's (FILTERING, GENOME
COMPARISON, CLUSTERING, SCORING, WARNINGS, TAXONOMY), so an argv the JAX
CLI takes parses here too; EXECUTION adds --device. --mesh_shape D runs
the dense ring over D positions dealt over the visible cards (all of them
on one card, or on the CPU); the JAX package's --ring_comm,
--ring_monolithic and the TPU-only --ring_vmem_mb are accepted and run the
port's one ring.
The streaming primary (--streaming_primary, --streaming_threshold,
--streaming_block) and its LSH pruning (--primary_prune lsh, --prune_bands,
--prune_min_shared, --prune_join_chunk) run as in the JAX package, and so
do --primary_estimator matmul, --multiround_primary_clustering,
--greedy_secondary_clustering and --run_tertiary_clustering, the
subprocess engines (--primary_algorithm mash, --S_algorithm
fastANI|ANImf|ANIn|gANI|goANI) and dereplicate's taxonomy (--run_tax
--cent_index). The fault-tolerance,
durable-I/O and elastic-pod flags run as in the JAX package
(--fault_retries, --dispatch_timeout, --io_retries, --fsync,
--no_overlap_ingest, --max_dead_processes, --max_joins, --drain_grace_s;
the `index` verbs take --io_retries and --fsync).
Event tracing (--events, default DREP_TORCH_EVENTS) and --profile [DIR]
(a torch.profiler Chrome trace of the cluster stage) run as in the JAX
package (workflows.py). Every flag of the JAX CLI's `compare` and
`dereplicate` runs.
`index build|update|classify|serve|route|split|merge|compact` take the
JAX CLI's flags plus --device, the federated ones included (`index build
--partitions/--fed_pods`, `index update --fed_pods/--params_file`,
`index serve --resident_mb`, `index serve|route --events`, `index route
--fleet_manifest`). `index supervise` (the fleet supervisor, a control
plane) takes the JAX CLI's flags and no --device: its replicas run where
its --spawn command says.
"""

from __future__ import annotations

import argparse

from drep_tpu_torch import __version__


# the elastic pod's flags: the cluster stage's, kept out of the index verbs'
# parameters
POD_FLAGS = ("max_dead_processes", "max_joins", "drain_grace_s")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="drep-tpu-torch",
        description="Genome dereplication and comparison on PyTorch/CUDA (dRep-compatible pipeline)",
    )
    parser.add_argument("--version", action="version", version=f"drep-tpu-torch {__version__}")
    sub = parser.add_subparsers(dest="operation", required=True)

    def add_common(p: argparse.ArgumentParser, with_filter: bool, with_scoring: bool):
        p.add_argument("work_directory", help="directory for tables, figures, logs (the resume checkpoint)")
        p.add_argument("-g", "--genomes", nargs="*", default=None, help="genome FASTA files")
        p.add_argument("-p", "--processes", type=int, default=6)
        p.add_argument("-d", "--debug", action="store_true")

        comp = p.add_argument_group("GENOME COMPARISON")
        comp.add_argument("--primary_algorithm", default="jax_mash",
                          help="primary (coarse) comparison engine [jax_mash|mash]")
        comp.add_argument("--primary_estimator", default="auto",
                          choices=["auto", "sort", "matmul"],
                          help="jax_mash Jaccard estimator: sort=union-bottom-s "
                               "(reference Mash; auto resolves to it), matmul=common-threshold "
                               "on the fused indicator kernel (csrc/indicator_mm.cu)")
        comp.add_argument("--S_algorithm", default="jax_ani",
                          help="secondary (ANI) comparison engine "
                               "[jax_ani|fastANI|ANImf|ANIn|gANI|goANI]")
        comp.add_argument("-ms", "--MASH_sketch", type=int, default=1000)
        comp.add_argument("--scale", type=int, default=200,
                          help="FracMinHash scale for jax_ani (smaller = more precise)")
        comp.add_argument("-k", "--kmer_size", type=int, default=21)
        comp.add_argument("--hash", default="splitmix64",
                          choices=["splitmix64", "murmur3"],
                          help="k-mer hash: splitmix64 (fastest) or murmur3 "
                               "(Mash-compatible for k>16)")
        comp.add_argument("--SkipMash", action="store_true")
        comp.add_argument("--SkipSecondary", action="store_true")
        comp.add_argument("-nc", "--cov_thresh", type=float, default=0.1)

        clus = p.add_argument_group("CLUSTERING")
        clus.add_argument("-pa", "--P_ani", type=float, default=0.9)
        clus.add_argument("-sa", "--S_ani", type=float, default=0.95)
        clus.add_argument("--clusterAlg", default="average",
                          choices=["average", "single", "complete", "weighted", "ward"])
        clus.add_argument("--multiround_primary_clustering", action="store_true")
        clus.add_argument("--primary_chunksize", type=int, default=5000)
        clus.add_argument("--greedy_secondary_clustering", action="store_true")
        clus.add_argument("--run_tertiary_clustering", action="store_true")
        clus.add_argument("--streaming_primary", action="store_true")
        clus.add_argument("--streaming_block", type=int, default=1024)
        clus.add_argument("--streaming_threshold", type=int, default=30_000,
                          help="genome count at which the primary stage switches to the "
                               "streaming path (stripe by stripe, shard checkpoints, sparse Mdb)")
        clus.add_argument("--primary_prune", default="off", choices=["off", "lsh"])
        clus.add_argument("--prune_bands", type=int, default=0)
        clus.add_argument("--prune_min_shared", type=int, default=0)
        clus.add_argument("--prune_join_chunk", type=int, default=0)

        warn = p.add_argument_group("WARNINGS")
        warn.add_argument("--warn_dist", type=float, default=0.25)
        warn.add_argument("--warn_sim", type=float, default=0.98)
        warn.add_argument("--warn_aln", type=float, default=0.25)

        ex = p.add_argument_group("EXECUTION")
        ex.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="where the kernels run (default cuda; cpu runs their plain "
                             "PyTorch versions and must be asked for)")
        ex.add_argument("--mesh_shape", type=int, default=None,
                        help="positions of the dense ring (default: one per card of the widest "
                             "ring of cards with peer access, one on the CPU); positions are dealt "
                             "round-robin over the cards, so several may share one")
        # the JAX CLI's ring flags, accepted so that its argv runs unchanged;
        # the port has one ring (step-wise, the copy fused into the kernel)
        ex.add_argument("--ring_monolithic", action="store_true",
                        help="accepted for the JAX CLI's argv; the port runs its one ring")
        ex.add_argument("--ring_comm", default="auto", choices=["auto", "ppermute", "pallas_dma"],
                        help="accepted for the JAX CLI's argv; the port's ring always writes the "
                             "B operand into the neighbour from inside the ring-step kernel")
        ex.add_argument("--ring_vmem_mb", type=int, default=None,
                        help="accepted for the JAX CLI's argv (a TPU VMEM budget); ignored")
        ex.add_argument("--skip_plots", action="store_true")
        ex.add_argument("--no_overlap_ingest", dest="overlap_ingest", action="store_false", default=True,
                        help="do not build the kernels and start the CUDA context on a thread while "
                             "ingest sketches")
        ex.add_argument("--fault_retries", type=int, default=2,
                        help="retries of a failed launch (a streaming stripe, a secondary engine call) "
                             "before the run raises FaultTolError")
        ex.add_argument("--dispatch_timeout", type=float, default=0.0,
                        help="watchdog in seconds on each streaming stripe and secondary engine call; "
                             "0 derives one for the streaming stripes from their own latencies (the "
                             "other launches run without), a negative value turns it off")
        ex.add_argument("--io_retries", type=int, default=None,
                        help="retries of a transient shared-filesystem error (EIO, ESTALE, ETIMEDOUT) "
                             "per durable read or write (default 3)")
        ex.add_argument("--fsync", action="store_true",
                        help="fsync every durable publish (the file, then its directory)")
        # the elastic pod's (parallel/faulttol.py): a run launched as N
        # processes (parallel/mesh.py)
        ex.add_argument("--max_dead_processes", type=int, default=1,
                        help="pod-member deaths the elastic pod tolerates a run (heartbeat staleness, then "
                             "an ownership-epoch bump that re-deals the dead member's unfinished "
                             "streaming stripes and dense-ring blocks over the survivors) before it "
                             "aborts; heartbeat cadence via DREP_TORCH_HEARTBEAT_S (0 disables)")
        ex.add_argument("--max_joins", type=int, default=0,
                        help="mid-run join admissions the pod accepts a stage: a new process started "
                             "against the same workdir with DREP_TORCH_POD_JOIN=auto (or an id) asks "
                             "admission, the lowest live member admits it at a stripe or ring-step "
                             "boundary, and the unfinished work re-deals over the grown set, with the "
                             "same edges and matrices; 0 (default) refuses joins")
        ex.add_argument("--drain_grace_s", type=float, default=30.0,
                        help="on SIGTERM a member finishes its stripe or ring step, publishes a "
                             "planned-departure note and exits 0 (its peers re-deal at once, no "
                             "staleness wait); unconsumed after this many seconds, it publishes the "
                             "note and exits 0 anyway")
        ex.add_argument("--events", default=None, choices=["off", "on"],
                        help="structured event tracing into <wd>/log/events.p0.jsonl "
                             "(default DREP_TORCH_EVENTS, off)")
        ex.add_argument("--profile", nargs="?", const="auto", default=None, metavar="DIR",
                        help="profile the cluster stage with torch.profiler (CPU and CUDA) into a "
                             "Chrome trace, DIR/trace.json (bare flag: <wd>/log/torch_trace)")

        if with_filter:
            tax = p.add_argument_group("TAXONOMY")
            tax.add_argument("--run_tax", action="store_true")
            tax.add_argument("--cent_index", default=None)

            filt = p.add_argument_group("FILTERING")
            filt.add_argument("-l", "--length", type=int, default=50_000)
            filt.add_argument("-comp", "--completeness", type=float, default=75.0)
            filt.add_argument("-con", "--contamination", type=float, default=25.0)
            filt.add_argument("--ignoreGenomeQuality", action="store_true")
            filt.add_argument("--genomeInfo", default=None,
                              help="CSV with genome,completeness,contamination")
            filt.add_argument("--checkM_method", default="lineage_wf",
                              choices=["lineage_wf", "taxonomy_wf"])

        if with_scoring:
            sc = p.add_argument_group("SCORING")
            sc.add_argument("-comW", "--completeness_weight", type=float, default=1.0)
            sc.add_argument("-conW", "--contamination_weight", type=float, default=5.0)
            sc.add_argument("-strW", "--strain_heterogeneity_weight", type=float, default=1.0)
            sc.add_argument("-N50W", "--N50_weight", type=float, default=0.5)
            sc.add_argument("-sizeW", "--size_weight", type=float, default=0.0)
            sc.add_argument("-centW", "--centrality_weight", type=float, default=1.0)
            sc.add_argument("--extra_weight_table", default=None)

    def add_index_io(p: argparse.ArgumentParser):
        p.add_argument("index_directory", help="the long-lived genome index")
        p.add_argument("-g", "--genomes", nargs="*", default=None, help="genome FASTA files")
        p.add_argument("-p", "--processes", type=int, default=6)
        p.add_argument("-d", "--debug", action="store_true")
        p.add_argument("--io_retries", type=int, default=None,
                       help="transient shared-filesystem I/O retry budget (utils/durableio.py; "
                            "same knob as the pipeline)")
        p.add_argument("--fsync", action="store_true",
                       help="fsync every durable publish")
        p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                       help="where the kernels run (default cuda; cpu runs their plain "
                            "PyTorch versions and must be asked for)")

    def add_prune(p: argparse.ArgumentParser):
        p.add_argument("--primary_prune", default="off", choices=["off", "lsh"],
                       help="LSH candidate pruning of the K x N rectangle (recall 1.0 at the "
                            "index's retention bound: the same edges and verdicts)")
        p.add_argument("--prune_bands", type=int, default=0)
        p.add_argument("--prune_min_shared", type=int, default=0)
        p.add_argument("--prune_join_chunk", type=int, default=0)

    idx_p = sub.add_parser(
        "index",
        help="incremental service mode: a long-lived genome index with "
             "build/update/classify entrypoints",
    )
    isub = idx_p.add_subparsers(dest="index_op", required=True)

    b = isub.add_parser(
        "build",
        help="create generation 0: snapshot a completed run's workdir "
             "(--work_directory) or bootstrap from FASTAs (-g)",
    )
    add_index_io(b)
    b.add_argument("--work_directory", default=None,
                   help="completed compare/dereplicate workdir to snapshot; omit to "
                        "bootstrap from -g FASTAs instead")
    b.add_argument("--partitions", type=int, default=0,
                   help="create a FEDERATED index: this many range partitions of the genome "
                        "space (each a full index store) under one atomically published "
                        "meta-manifest (index/federation.py). Bootstrap (-g) builds only; "
                        "routing is by sketch-derived range code, pinned at creation. "
                        "0 = one store")
    b.add_argument("--fed_pods", type=int, default=None,
                   help="with --partitions: run the partitions' generation 0 as up to this many "
                        "concurrent subprocess pods (sketches and pinned params ride a "
                        "--params_file handoff into each pod)")
    bp = b.add_argument_group("INDEX PARAMETERS (bootstrap build only; "
                              "workdir builds pin the source run's)")
    bp.add_argument("-pa", "--P_ani", type=float, default=None)
    bp.add_argument("-sa", "--S_ani", type=float, default=None)
    bp.add_argument("-nc", "--cov_thresh", type=float, default=None)
    bp.add_argument("--clusterAlg", default=None, choices=["average", "single"])
    bp.add_argument("-ms", "--MASH_sketch", type=int, default=None)
    bp.add_argument("--scale", type=int, default=None)
    bp.add_argument("-k", "--kmer_size", type=int, default=None)
    bp.add_argument("--hash", default=None, choices=["splitmix64", "murmur3"])
    bp.add_argument("--warn_dist", type=float, default=None)
    bp.add_argument("-l", "--length", type=int, default=None,
                    help="minimum genome length admitted (the filter stage's rule)")
    bp.add_argument("--streaming_block", type=int, default=None)

    u = isub.add_parser(
        "update",
        help="admit K new genomes: sketch K, compare K x N on the Mash kernel, "
             "re-cluster only touched clusters, publish the next generation "
             "(crash-resumable; with no -g this is a pure heal pass)",
    )
    add_index_io(u)
    add_prune(u)
    u.add_argument("--fed_pods", type=int, default=None,
                   help="FEDERATED index only: run the per-partition updates as up to this many "
                        "concurrent subprocess pods (each the ordinary `index update` on one "
                        "partition store). Default 0: in process, one at a time")
    u.add_argument("--params_file", default=None, metavar="NPZ",
                   help="sketches+params handoff from a federated router "
                        "(index/federation.py write_params_handoff): the routed batch's sketches "
                        "and the federation's pinned params, so a partition pod never re-sketches "
                        "and an empty partition materializes generation 0. With it, -g is "
                        "ignored: the handoff is the batch")

    c = isub.add_parser(
        "classify",
        help="membership query: the cluster/winner each FASTA would join, "
             "answered from the index alone (read-only)",
    )
    add_index_io(c)
    add_prune(c)

    s = isub.add_parser(
        "serve",
        help="resident serving tier: a long-lived daemon that loads the index once, "
             "dynamically batches concurrent classify queries over a local socket into one "
             "K x N rectangle against the sketch matrix held on the device, hot-swaps to "
             "newly published generations, and drains on SIGTERM (verdicts identical to "
             "one-shot classify; the index stays byte-for-byte untouched)",
    )
    s.add_argument("index_directory", help="the long-lived genome index")
    s.add_argument("-p", "--processes", type=int, default=1,
                   help="sketching processes per batch (queries are small; 1 keeps the daemon "
                        "single-sketcher)")
    s.add_argument("-d", "--debug", action="store_true")
    s.add_argument("--io_retries", type=int, default=None,
                   help="transient shared-filesystem I/O retry budget (same knob as the pipeline)")
    s.add_argument("--fsync", action="store_true", help="fsync every durable publish")
    s.add_argument("--socket", default=None, metavar="PATH",
                   help="serve on a unix-domain socket at PATH instead of TCP")
    s.add_argument("--host", default="127.0.0.1",
                   help="TCP bind host (default 127.0.0.1: the daemon is a local front door)")
    s.add_argument("--port", type=int, default=0,
                   help="TCP bind port (default 0 = OS-assigned; the bound address is printed "
                        "as the JSON ready line)")
    s.add_argument("--max_queue", type=int, default=256,
                   help="admission-queue bound: a request arriving at a full queue is refused "
                        "at once with a retry_after_s hint. Default 256")
    s.add_argument("--max_batch", type=int, default=64,
                   help="most queries coalesced into one rectangle (1 = unbatched FIFO). "
                        "Default 64")
    s.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="how long the first waiting query holds the batch open for late "
                        "arrivals. Default 5 ms")
    s.add_argument("--poll_generation_s", type=float, default=2.0,
                   help="manifest re-read cadence for the generation hot swap. Default 2 s")
    s.add_argument("--resident_mb", type=int, default=None,
                   help="a federated root's residency budget (MiB) for partition sketch "
                        "payloads, evicted least recently used between batches (default: no "
                        "budget); unused on a plain root")
    s.add_argument("--log_dir", default=None,
                   help="home for the daemon's logs and perf counters; never the index "
                        "directory (default: console-only logging, no files)")
    s.add_argument("--events", default=None, choices=["off", "on"],
                   help="event tracing of the serve timeline into --log_dir (default DREP_TORCH_EVENTS)")
    add_prune(s)
    s.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the kernels run (default cuda; cpu runs their plain "
                        "PyTorch versions and must be asked for)")

    r = isub.add_parser(
        "route",
        help="fleet front door (stateless router): speaks the serve protocol in front of N "
             "`index serve` replicas of a federated root, forwards a query one replica covers, "
             "scatters the others as per-partition legs and merges them through the federated "
             "recluster (verdicts byte-identical to one daemon's), generation-fences the fan-out, "
             "hedges stragglers, and degrades to stamped PARTIAL verdicts under replica loss or "
             "overload",
    )
    r.add_argument("index_directory",
                   help="the federated root the fleet serves (the router loads its spine and "
                        "routing bitmaps, no sketch payloads)")
    r.add_argument("--replica", action="append", default=[], metavar="ADDR[=PIDS]",
                   help="one serve replica: host:port or socket path, optionally '=' a partition "
                        "assignment as ids/inclusive ranges (0-2,5); no assignment serves every "
                        "partition. Repeatable; replicas can also join/leave a running router "
                        "through the fleet op")
    r.add_argument("-p", "--processes", type=int, default=1,
                   help="sketching processes per batch (1 keeps the router single-sketcher)")
    r.add_argument("-d", "--debug", action="store_true")
    r.add_argument("--io_retries", type=int, default=None,
                   help="transient shared-filesystem I/O retry budget (same knob as the pipeline)")
    r.add_argument("--socket", default=None, metavar="PATH",
                   help="serve on a unix-domain socket at PATH instead of TCP")
    r.add_argument("--host", default="127.0.0.1", help="TCP bind host (default 127.0.0.1)")
    r.add_argument("--port", type=int, default=0,
                   help="TCP bind port (default 0 = OS-assigned; printed as the JSON ready line)")
    r.add_argument("--max_inflight", type=int, default=None,
                   help="bounded admission: queued classify requests before the router refuses "
                        "with backpressure. Default 256")
    r.add_argument("--max_batch", type=int, default=64,
                   help="most queries routed as one scatter/forward round. Default 64")
    r.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="batch-formation window. Default 5 ms")
    r.add_argument("--poll_generation_s", type=float, default=2.0,
                   help="meta-manifest re-read cadence of the router's own generation hot swap "
                        "(a fenced gather reloads sooner when the fleet is ahead). Default 2 s")
    r.add_argument("--leg_timeout_s", type=float, default=None,
                   help="socket deadline of one scatter/forward dispatch. Default 30 s")
    r.add_argument("--hedge_delay_s", type=float, default=None,
                   help="straggler hedge: duplicate an unanswered leg to a second capable "
                        "replica after this long (the first answer wins). Default 2 s")
    r.add_argument("--probe_interval_s", type=float, default=1.0,
                   help="replica /healthz poll cadence feeding the healthy -> suspect -> "
                        "ejected table. Default 1 s")
    r.add_argument("--probe_backoff_s", type=float, default=None,
                   help="first reprobe delay after an ejection (doubling to 60 s). Default 1 s")
    r.add_argument("--fleet_manifest", default=None, metavar="PATH",
                   help="the fleet supervisor's fleet.json (or its directory): the router adds its "
                        "healthy slots to the replica table at start (membership survives a router "
                        "restart with no fleet join replayed) and reports the supervision tree in "
                        "/healthz. Read-only; only `index supervise` writes it")
    r.add_argument("--resident_mb", type=int, default=None,
                   help="budget (MiB) of the router's own lazily loaded component sketches (the "
                        "merge's secondary recluster; the rectangles run on the replicas). "
                        "Default: no budget")
    r.add_argument("--log_dir", default=None,
                   help="home for the router's logs and perf counters; never the index directory")
    r.add_argument("--events", default=None, choices=["off", "on"],
                   help="event tracing of the router into --log_dir (default DREP_TORCH_EVENTS)")
    r.add_argument("--primary_prune", default="off", choices=["off", "lsh"],
                   help="LSH candidate pruning, forwarded to every scatter leg so the whole fleet "
                        "prunes alike")
    r.add_argument("--prune_bands", type=int, default=0)
    r.add_argument("--prune_min_shared", type=int, default=0)
    r.add_argument("--prune_join_chunk", type=int, default=0)
    r.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the router's merge runs its kernels (default cuda; cpu runs their "
                        "plain PyTorch versions and must be asked for)")

    def add_maint_io(p: argparse.ArgumentParser):
        p.add_argument("index_directory", help="the long-lived genome index")
        p.add_argument("-p", "--processes", type=int, default=6)
        p.add_argument("-d", "--debug", action="store_true")
        p.add_argument("--io_retries", type=int, default=None,
                       help="transient shared-filesystem I/O retry budget (same knob as the pipeline)")
        p.add_argument("--fsync", action="store_true", help="fsync every durable publish")
        p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                       help="where the kernels run (default cuda; cpu runs their plain "
                            "PyTorch versions and must be asked for)")

    sp = isub.add_parser(
        "split",
        help="index lifecycle: bisect a FEDERATED partition's range at its sketch-code median "
             "into two child partition stores, a staged meta-manifest transaction (children "
             "under pending/, one atomic federation.json commit, the parent removed after); "
             "crash-safe at every phase",
    )
    add_maint_io(sp)
    sp.add_argument("--pid", type=int, required=True,
                    help="the partition id to split (pids are renumbered densely by range order "
                         "at commit)")
    mg = isub.add_parser(
        "merge",
        help="index lifecycle: fold two ADJACENT federated partitions into one (the split's "
             "inverse, the same staged transaction)",
    )
    add_maint_io(mg)
    mg.add_argument("--pids", type=int, nargs=2, required=True, metavar=("PID_A", "PID_B"),
                    help="the two adjacent partition ids to fold")
    cp = isub.add_parser(
        "compact",
        help="index lifecycle: fold a store's N sketch/edge/state shard generations into one "
             "and remove the superseded shards (a federated root compacts per partition and "
             "commits through the meta-manifest; classify and update answer as on the "
             "uncompacted store)",
    )
    add_maint_io(cp)
    cp.add_argument("--pid", type=int, default=None,
                    help="compact only this federated partition (default: every partition past "
                         "--min_generations)")
    cp.add_argument("--min_generations", type=int, default=None,
                    help="without --pid: compact partitions holding at least this many shard "
                         "generations (default 4)")

    v = isub.add_parser(
        "supervise",
        help="fleet supervisor: owns the replica processes of a serving fleet against a durable "
             "fleet.json manifest: spawn under a startup deadline, liveness and /healthz every "
             "heartbeat, restart on death with decorrelated backoff, crash-loop QUARANTINE after "
             "K deaths in a window, graceful drain with SIGKILL escalation. A restart adopts the "
             "live replicas of the manifest (never spawns twice); a restarted router rebuilds its "
             "membership from the same file",
    )
    v.add_argument("index_directory",
                   help="the FEDERATED root the supervised fleet serves (the manifest lives under "
                        "<root>/fleet unless --fleet_dir says otherwise)")
    v.add_argument("--fleet_dir", default=None, metavar="DIR",
                   help="home of fleet.json and its generation snapshots. Default "
                        "<index_directory>/fleet")
    v.add_argument("--spawn", default=None, metavar="CMD",
                   help="the `index serve` command line of ONE replica ('{partitions}' becomes a "
                        "slot's comma list, nothing for an unscoped slot). Without it the supervisor "
                        "only adopts and retires what the manifest records")
    v.add_argument("--replica", action="append", default=[], metavar="N[=PIDS]",
                   help="initial placement: N unscoped replicas, or 'N=0-2,5' scoped to a partition "
                        "set. Repeatable; applied once at start for ranges the manifest does not "
                        "already hold")
    v.add_argument("--router", default=None, metavar="ADDR",
                   help="a running `index route` to announce fleet join/leave to (advisory: a router "
                        "that is down rebuilds from the manifest when it returns)")
    v.add_argument("--heartbeat_s", type=float, default=None,
                   help="liveness tick cadence (pid poll + /healthz). Default DREP_TORCH_SUP_HEARTBEAT_S")
    v.add_argument("--backoff_max_s", type=float, default=None,
                   help="cap of the decorrelated restart backoff. Default DREP_TORCH_SUP_BACKOFF_MAX_S")
    v.add_argument("--crashloop_k", type=int, default=None,
                   help="deaths inside the window that QUARANTINE a slot (0: never). Default "
                        "DREP_TORCH_SUP_CRASHLOOP_K")
    v.add_argument("--crashloop_window_s", type=float, default=None,
                   help="the crash-loop window. Default DREP_TORCH_SUP_CRASHLOOP_WINDOW_S")
    v.add_argument("--drain_deadline_s", type=float, default=None,
                   help="seconds after SIGTERM before a draining replica is SIGKILLed (escalations "
                        "counted). Default DREP_TORCH_SUP_DRAIN_DEADLINE_S")
    v.add_argument("--startup_deadline_s", type=float, default=None,
                   help="seconds a spawned replica gets to print its ready line before the spawn "
                        "books a death. Default DREP_TORCH_SUP_STARTUP_DEADLINE_S")
    v.add_argument("--ticks", type=int, default=0,
                   help="exit after this many supervision ticks (0: run until interrupted)")
    v.add_argument("-d", "--debug", action="store_true")
    v.add_argument("--io_retries", type=int, default=None,
                   help="transient shared-filesystem I/O retry budget (same knob as the pipeline)")
    v.add_argument("--log_dir", default=None,
                   help="home for the supervisor's logs and event traces; never the index directory")
    v.add_argument("--events", default=None, choices=["off", "on"],
                   help="event tracing (supervisor_spawn/death/quarantine/escalation instants) into "
                        "--log_dir (default DREP_TORCH_EVENTS)")

    cmp_p = sub.add_parser("compare", help="cluster genomes without dereplicating")
    add_common(cmp_p, with_filter=False, with_scoring=False)

    der_p = sub.add_parser("dereplicate", help="filter, cluster, and pick winner genomes")
    add_common(der_p, with_filter=True, with_scoring=True)

    sub.add_parser("check_dependencies", help="report the cards and the CUDA toolkit the port would use")
    return parser


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)
