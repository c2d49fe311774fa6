"""Top-level workflows composing the pipeline stages.

Counterpart of drep_tpu/workflows.py (compare and dereplicate):
dereplicate = filter -> cluster -> choose -> evaluate -> analyze;
compare = cluster -> evaluate -> analyze (no filter/choose).

Both run on `device` (default cuda); a CUDA request on a machine without
CUDA, or a JAX CLI flag set to a value the port does not run
(argparser.UNPORTED_FLAGS), raises before any work is done.
"""

from __future__ import annotations

import pandas as pd

from drep_tpu_torch.argparser import refuse_unported_flags
from drep_tpu_torch.choose import d_choose_wrapper
from drep_tpu_torch.cluster.controller import d_cluster_wrapper
from drep_tpu_torch.device import resolve_device
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.evaluate import d_evaluate_wrapper
from drep_tpu_torch.filter import d_filter_wrapper
from drep_tpu_torch.ingest import make_bdb
from drep_tpu_torch.utils.logger import get_logger, setup_logger
from drep_tpu_torch.workdir import WorkDirectory


def _init(wd_loc: str, genomes: list[str]) -> tuple[WorkDirectory, pd.DataFrame]:
    wd = WorkDirectory(wd_loc)
    setup_logger(wd.get_dir("log"))
    if genomes:
        bdb = make_bdb(genomes)
        wd.store_db(bdb, "Bdb")
    elif wd.hasDb("Bdb"):
        bdb = wd.get_db("Bdb")  # resume from an existing workdir
    else:
        raise UserInputError("no genomes given and workdir has no stored Bdb")
    return wd, bdb


def compare_wrapper(
    wd_loc: str, genomes: list[str] | None = None, device=None, **kwargs
) -> pd.DataFrame:
    """`compare`: cluster + evaluate + analyze. Returns Cdb."""
    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    wd, bdb = _init(wd_loc, genomes or [])
    cdb = d_cluster_wrapper(wd, bdb, device=dev, **kwargs)
    # per-genome stats for downstream stages come from the ingest pass's Gdb
    wd.store_db(wd.get_db("Gdb")[["genome", "length", "N50", "contigs"]], "genomeInformation")
    d_evaluate_wrapper(wd, **kwargs)
    if not kwargs.get("skip_plots", False):
        from drep_tpu_torch.analyze import plot_all

        plot_all(wd)
    get_logger().info("compare finished: %d genomes, %d secondary clusters",
                      len(cdb), cdb["secondary_cluster"].nunique())
    return cdb


def dereplicate_wrapper(
    wd_loc: str, genomes: list[str] | None = None, device=None, **kwargs
) -> pd.DataFrame:
    """`dereplicate`: filter + cluster + choose + evaluate + analyze.
    Returns Wdb (the winners)."""
    refuse_unported_flags(kwargs)
    dev = resolve_device(device)
    wd, bdb = _init(wd_loc, genomes or [])
    filtered = d_filter_wrapper(wd, bdb, genomeInfo=kwargs.pop("genomeInfo", None), **kwargs)
    d_cluster_wrapper(wd, filtered, device=dev, **kwargs)
    wdb = d_choose_wrapper(wd, filtered, **kwargs)
    d_evaluate_wrapper(wd, **kwargs)
    if not kwargs.get("skip_plots", False):
        from drep_tpu_torch.analyze import plot_all

        plot_all(wd)
    get_logger().info("dereplicate finished: %d winners", len(wdb))
    return wdb
