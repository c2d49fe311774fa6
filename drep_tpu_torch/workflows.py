"""Top-level workflows composing the pipeline stages.

Counterpart of drep_tpu/workflows.py (compare, dereplicate and the
genome index):
dereplicate = filter -> cluster -> choose -> [bonus] -> evaluate -> analyze;
compare = cluster -> evaluate -> analyze (no filter/choose);
index build|update|classify|split|merge|compact = drep_tpu_torch/index;
index serve|route = drep_tpu_torch/serve.

All run on `device` (default cuda); a CUDA request on a machine without
CUDA, or a JAX CLI flag set to a value the port does not run
(argparser.UNPORTED_FLAGS), raises before any work is done. Each
installs the run's durable-I/O policy (--io_retries, --fsync) before its
first write.

Observability, as in the JAX package: ``--events on`` (or
``DREP_TORCH_EVENTS``) traces the run into ``<wd>/log/events.p0.jsonl``
(utils/telemetry.py): the ``stage:filter|cluster|choose|evaluate`` spans,
the cluster stage's own, and ``run_finished``; ``--profile [DIR]`` runs
the cluster stage under ``torch.profiler`` and writes a Chrome trace to
DIR, by default ``<wd>/log/torch_trace``; ``DREP_TORCH_METRICS_FLUSH_S``
publishes ``<wd>/log/metrics.prom`` periodically; and every run writes
``<wd>/log/perf_counters.json``. The index verbs trace into the index's
own log dir, except ``classify``, which writes nothing under the index;
``index serve|route`` trace into ``--log_dir``.
"""

from __future__ import annotations

import pandas as pd

from drep_tpu_torch.argparser import UNPORTED_FLAGS, refuse_unported_flags
from drep_tpu_torch.bonus import d_bonus_wrapper, validate_bonus_args
from drep_tpu_torch.choose import d_choose_wrapper
from drep_tpu_torch.cluster.anim import reset_run_state
from drep_tpu_torch.cluster.controller import d_cluster_wrapper
from drep_tpu_torch.device import resolve_device
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.evaluate import d_evaluate_wrapper
from drep_tpu_torch.filter import d_filter_wrapper
from drep_tpu_torch.ingest import make_bdb
from drep_tpu_torch.utils import telemetry
from drep_tpu_torch.utils.logger import get_logger, setup_logger
from drep_tpu_torch.utils.profiling import counters, start_metrics_flush, stop_metrics_flush, trace
from drep_tpu_torch.workdir import WorkDirectory


def _configure_io(kwargs: dict) -> None:
    """--io_retries / --fsync -> utils/durableio.py, for every publish and
    read of the run (unset flags keep the defaults); and the
    DREP_TORCH_FAULTS spec parsed now, so that a malformed or unported
    one raises before anything is written."""
    from drep_tpu_torch.utils import durableio, faults

    durableio.configure(retries=kwargs.get("io_retries"), fsync=bool(kwargs.get("fsync")) or None)
    faults.active()


def _init(wd_loc: str, genomes: list[str], events=None) -> tuple[WorkDirectory, pd.DataFrame]:
    wd = WorkDirectory(wd_loc)
    setup_logger(wd.get_dir("log"))
    # the event sink (--events / DREP_TORCH_EVENTS; off: no file) and the
    # periodic metrics flush (DREP_TORCH_METRICS_FLUSH_S; 0: no thread)
    telemetry.configure(log_dir=wd.get_dir("log"), enabled=events, pid=0)
    start_metrics_flush(wd.get_dir("log"))
    counters.reset()  # fresh per run: library users may run several workflows in one process
    reset_run_state()  # a second run in this process warns again, as a second CLI run would
    if genomes:
        bdb = make_bdb(genomes)
        wd.store_db(bdb, "Bdb")
    elif wd.hasDb("Bdb"):
        bdb = wd.get_db("Bdb")  # resume from an existing workdir
    else:
        raise UserInputError("no genomes given and workdir has no stored Bdb")
    return wd, bdb


def _trace_dir(wd: WorkDirectory, profile) -> str | None:
    """--profile's directory: the one given, or ``<wd>/log/torch_trace``
    for the bare flag; None without it."""
    if not profile:
        return None
    return profile if isinstance(profile, str) and profile != "auto" else wd.get_dir("log/torch_trace")


def _finish_counters(wd: WorkDirectory) -> None:
    """The run's epilogue: the last metrics flush, perf_counters.json, the
    ``run_finished`` instant and the sink's close."""
    stop_metrics_flush(final=True)
    rep = counters.report()
    path = counters.write(wd.get_dir("log"))
    telemetry.event("run_finished", pairs=rep["total"]["pairs"])
    telemetry.close()
    total = rep["total"]
    get_logger().info(
        "perf: %d pairs in %.2fs = %s pairs/sec/chip (%d chip(s)) -> %s",
        total["pairs"], total["seconds"], total["pairs_per_sec_per_chip"], rep["n_chips"], path,
    )


def compare_wrapper(
    wd_loc: str, genomes: list[str] | None = None, device=None, **kwargs
) -> pd.DataFrame:
    """`compare`: cluster + evaluate + analyze. Returns Cdb."""
    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    _configure_io(kwargs)
    events, profile = kwargs.pop("events", None), kwargs.pop("profile", None)
    wd, bdb = _init(wd_loc, genomes or [], events=events)
    with trace(_trace_dir(wd, profile)), telemetry.span("stage:cluster"):
        cdb = d_cluster_wrapper(wd, bdb, device=dev, **kwargs)
    # per-genome stats for downstream stages come from the ingest pass's Gdb
    wd.store_db(wd.get_db("Gdb")[["genome", "length", "N50", "contigs"]], "genomeInformation")
    with telemetry.span("stage:evaluate"):
        d_evaluate_wrapper(wd, **kwargs)
    if not kwargs.get("skip_plots", False):
        from drep_tpu_torch.analyze import plot_all

        plot_all(wd)
    _finish_counters(wd)
    get_logger().info("compare finished: %d genomes, %d secondary clusters",
                      len(cdb), cdb["secondary_cluster"].nunique())
    return cdb


def dereplicate_wrapper(
    wd_loc: str, genomes: list[str] | None = None, device=None, **kwargs
) -> pd.DataFrame:
    """`dereplicate`: filter + cluster + choose (+ taxonomy under
    --run_tax) + evaluate + analyze. Returns Wdb (the winners)."""
    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    validate_bonus_args(kwargs)  # centrifuge and its index, before any table is written
    _configure_io(kwargs)
    events, profile = kwargs.pop("events", None), kwargs.pop("profile", None)
    wd, bdb = _init(wd_loc, genomes or [], events=events)
    with telemetry.span("stage:filter"):
        filtered = d_filter_wrapper(wd, bdb, genomeInfo=kwargs.pop("genomeInfo", None), **kwargs)
    with trace(_trace_dir(wd, profile)), telemetry.span("stage:cluster"):
        d_cluster_wrapper(wd, filtered, device=dev, **kwargs)
    with telemetry.span("stage:choose"):
        wdb = d_choose_wrapper(wd, filtered, **kwargs)
    if kwargs.get("run_tax"):
        d_bonus_wrapper(wd, filtered, cent_index=kwargs.get("cent_index"), processes=kwargs.get("processes", 1))
    with telemetry.span("stage:evaluate"):
        d_evaluate_wrapper(wd, **kwargs)
    if not kwargs.get("skip_plots", False):
        from drep_tpu_torch.analyze import plot_all

        plot_all(wd)
    _finish_counters(wd)
    get_logger().info("dereplicate finished: %d winners", len(wdb))
    return wdb


def _init_index(index_loc: str, device, kwargs: dict, write_logs: bool = True):
    """An index command's checks, then its logging: the unported flags and
    the device are refused before anything is written; then the logger,
    the event sink (DREP_TORCH_EVENTS) and the metrics flush go under the
    index's log dir and the counters restart. `write_logs=False`
    (classify) keeps logging on the console and tracing and the flush
    off: classify writes nothing under the index tree. Returns the
    device."""
    import os

    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    _configure_io(kwargs)
    log_dir = None
    if write_logs:
        log_dir = os.path.join(os.path.abspath(index_loc), "log")
        os.makedirs(log_dir, exist_ok=True)
    setup_logger(log_dir)
    telemetry.configure(log_dir=log_dir)
    if log_dir is not None:
        start_metrics_flush(log_dir)
    else:
        stop_metrics_flush()
    counters.reset()
    return dev


def _prune_kwargs(kwargs: dict) -> dict:
    return {
        "processes": kwargs.get("processes", 1) or 1,
        "primary_prune": kwargs.get("primary_prune", "off") or "off",
        "prune_bands": kwargs.get("prune_bands", 0) or 0,
        "prune_min_shared": kwargs.get("prune_min_shared", 0) or 0,
        "prune_join_chunk": kwargs.get("prune_join_chunk", 0) or 0,
    }


def index_build_wrapper(
    index_loc: str, genomes: list[str] | None = None, work_directory: str | None = None,
    device=None, **kwargs,
) -> dict:
    """`index build`: generation 0 from a completed workdir snapshot
    (--work_directory) or bootstrapped from FASTAs (-g). With
    ``--partitions N`` the bootstrap creates a federated index: N range
    partitions under one meta-manifest, the whole input admitted as
    federation generation 0 (``--fed_pods``: the partitions as pods)."""
    from drep_tpu_torch.index import build_federated, build_from_paths, build_from_workdir

    dev = _init_index(index_loc, device, kwargs)
    if work_directory and genomes:
        raise UserInputError("index build takes --work_directory OR -g genomes, not both")
    partitions = int(kwargs.pop("partitions", 0) or 0)
    fed_pods = kwargs.pop("fed_pods", None)
    if work_directory:
        if partitions:
            raise UserInputError(
                "index build --partitions is a bootstrap (-g) mode: a "
                "workdir snapshot has no per-genome routing pass — build "
                "federated from the FASTAs instead"
            )
        return build_from_workdir(index_loc, work_directory)
    if genomes:
        processes = kwargs.get("processes", 1) or 1
        params = {k: v for k, v in kwargs.items() if k not in ("processes", *UNPORTED_FLAGS)}
        if partitions:
            return build_federated(index_loc, genomes, partitions, processes=processes, fed_pods=fed_pods,
                                   device=dev, **params)
        return build_from_paths(index_loc, genomes, processes=processes, device=dev, **params)
    raise UserInputError(
        "index build needs a source: --work_directory <completed run> or "
        "-g <genome FASTAs>"
    )


def index_update_wrapper(index_loc: str, genomes: list[str] | None = None, device=None, **kwargs) -> dict:
    """`index update`: admit a batch (or heal, with no genomes). A
    federated root routes by range code and updates its partitions as
    independent units (``--fed_pods``: concurrent subprocess pods)."""
    from drep_tpu_torch.index import index_update

    dev = _init_index(index_loc, device, kwargs)
    return index_update(index_loc, genomes, device=dev, fed_pods=kwargs.get("fed_pods"),
                        params_file=kwargs.get("params_file"), **_prune_kwargs(kwargs))


def index_maintenance_wrapper(index_loc: str, op: str, device=None, **kwargs) -> dict:
    """`index split|merge|compact`: the transactional index lifecycle
    (index/maintenance.py). Each verb first converges an interrupted
    earlier transaction (roll_forward), then runs its own."""
    from drep_tpu_torch.index import fed_compact, fed_merge, fed_split

    dev = _init_index(index_loc, device, kwargs)
    processes = kwargs.get("processes", 1) or 1
    if op == "split":
        summary = fed_split(index_loc, int(kwargs["pid"]), processes=processes, device=dev)
    elif op == "merge":
        pid_a, pid_b = kwargs["pids"]
        summary = fed_merge(index_loc, int(pid_a), int(pid_b), processes=processes, device=dev)
    else:
        from drep_tpu_torch.utils import envknobs

        min_gens = kwargs.get("min_generations")
        if min_gens is None:
            min_gens = envknobs.env_int("DREP_TORCH_COMPACT_MIN_SHARDS")
        summary = fed_compact(index_loc, pid=kwargs.get("pid"), processes=processes,
                              min_generations=int(min_gens), device=dev)
    get_logger().info("index %s summary: %s", op, summary)
    return summary


def index_classify_wrapper(index_loc: str, genomes: list[str] | None = None, device=None,
                           **kwargs) -> list[dict]:
    """`index classify`: read-only membership verdicts."""
    from drep_tpu_torch.index import index_classify

    if not genomes:
        raise UserInputError("index classify needs -g <genome FASTAs>")
    dev = _init_index(index_loc, device, kwargs, write_logs=False)
    return index_classify(index_loc, genomes, device=dev, **_prune_kwargs(kwargs))


def _serve_front_door(index_loc: str, kwargs: dict, what: str, device):
    """The set-up `index serve` and `index route` share: what the port
    does not run refuses first, then the device resolves, the durable-I/O
    policy is installed, the console keeps the controller's verbosity,
    the event sink (``--events`` / DREP_TORCH_EVENTS) and the metrics
    flush go to the log dir and the counters restart. Both are pure
    readers of the index, so their logs, counters and events live under
    ``--log_dir`` (outside the index tree) or nowhere; tracing without a
    log dir is refused. Returns (the absolute log_dir or None, the
    device)."""
    import logging
    import os

    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    _configure_io(kwargs)
    log_dir = kwargs.get("log_dir") or None
    if telemetry.resolve_enabled(kwargs.get("events")) and not log_dir:
        raise UserInputError(
            f"--events on needs --log_dir (the {'daemon' if what == 'serve' else 'router'} never writes under "
            f"the index directory, so traces have nowhere to go)"
        )
    if log_dir:
        log_dir = os.path.abspath(log_dir)
        idx_abs = os.path.abspath(index_loc)
        if log_dir == idx_abs or log_dir.startswith(idx_abs + os.sep):
            raise UserInputError(
                f"--log_dir {log_dir} is inside the index directory — the "
                f"{'daemon' if what == 'serve' else 'router'} is read-only by contract; point it elsewhere"
            )
        os.makedirs(log_dir, exist_ok=True)
    # keep the console verbosity the controller already set for -d:
    # setup_logger replaces handlers
    console_lvl = next(
        (h.level for h in get_logger().handlers if isinstance(h, logging.StreamHandler)), logging.INFO,
    )
    setup_logger(log_dir, verbosity=console_lvl or logging.INFO)
    telemetry.configure(log_dir=log_dir, enabled=kwargs.get("events"))
    if log_dir:
        start_metrics_flush(log_dir)
    else:
        stop_metrics_flush()
    counters.reset()
    return log_dir, dev


def _serve_kwargs(index_loc: str, kwargs: dict, log_dir: str | None, dev) -> dict:
    """The ServeConfig fields `index serve` and `index route` share."""
    return {
        "index_loc": index_loc,
        "host": kwargs.get("host", "127.0.0.1") or "127.0.0.1",
        "port": int(kwargs.get("port", 0) or 0),
        "socket_path": kwargs.get("socket") or None,
        "max_batch": int(kwargs.get("max_batch", 64) or 64),
        "batch_window_ms": float(kwargs.get("batch_window_ms", 5.0) or 0.0),
        "poll_generation_s": float(kwargs.get("poll_generation_s", 2.0) or 2.0),
        "processes": int(kwargs.get("processes", 1) or 1),
        "prune_cfg": {
            "primary_prune": kwargs.get("primary_prune", "off") or "off",
            "prune_bands": int(kwargs.get("prune_bands", 0) or 0),
            "prune_min_shared": int(kwargs.get("prune_min_shared", 0) or 0),
            "prune_join_chunk": int(kwargs.get("prune_join_chunk", 0) or 0),
        },
        "log_dir": log_dir,
        "resident_mb": kwargs.get("resident_mb"),
        "device": dev,
    }


def _run_server(server, log_dir: str | None) -> int:
    from drep_tpu_torch.serve import install_signal_handlers

    install_signal_handlers(server)
    try:
        return server.run()
    finally:
        stop_metrics_flush(final=bool(log_dir))
        if log_dir:
            counters.write(log_dir)
        telemetry.close()


def index_serve_wrapper(index_loc: str, device=None, **kwargs) -> int:
    """`index serve`: the resident serving tier (drep_tpu_torch/serve/):
    load once, batch dynamically, hot-swap generations, drain on SIGTERM.
    Blocks until drained; returns run()'s exit status (0). On a federated
    root it loads the streaming resident, whose residency budget is
    ``--resident_mb`` (default DREP_TORCH_SERVE_RESIDENT_MB)."""
    from drep_tpu_torch.serve import IndexServer, ServeConfig

    log_dir, dev = _serve_front_door(index_loc, kwargs, "serve", device)
    cfg = ServeConfig(max_queue=int(kwargs.get("max_queue", 256) or 256),
                      **_serve_kwargs(index_loc, kwargs, log_dir, dev))
    return _run_server(IndexServer(cfg), log_dir)


def index_route_wrapper(index_loc: str, device=None, **kwargs) -> int:
    """`index route`: the fleet front door (drep_tpu_torch/serve/router.py),
    a stateless scatter/gather router over `index serve` replicas of a
    federated root. Blocks until drained; returns run()'s exit status (0).
    An empty ``--replica`` list is legal (replicas may join through the
    ``fleet`` op); queries before a join are refused with ``no_replicas``.

    Refused before anything is read: ``--fleet_manifest`` (the
    supervisor's manifest, ROADMAP.md queue 1 item 11c)."""
    from drep_tpu_torch.serve.router import RouterConfig, RouterServer, refuse_fleet_manifest

    refuse_fleet_manifest(kwargs.get("fleet_manifest"))
    log_dir, dev = _serve_front_door(index_loc, kwargs, "route", device)
    replicas = list(kwargs.get("replica") or [])
    if not replicas:
        get_logger().warning(
            "index route starting with an empty replica table — queries "
            "will be refused (no_replicas) until a `fleet` join arrives"
        )
    # flags left unset keep RouterConfig's defaults (the DREP_TORCH_ROUTER_* knobs)
    knobs = {k: kwargs[k] for k in ("max_inflight", "leg_timeout_s", "hedge_delay_s", "probe_backoff_s")
             if kwargs.get(k) is not None}
    cfg = RouterConfig(
        **_serve_kwargs(index_loc, kwargs, log_dir, dev), replicas=replicas,
        probe_interval_s=float(kwargs.get("probe_interval_s", 1.0) or 1.0), **knobs,
    )
    return _run_server(RouterServer(cfg), log_dir)
