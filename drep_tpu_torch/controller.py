"""Top-level controller: parsed args -> workflow (drep_tpu/controller.py:
compare, dereplicate, index and check_dependencies)."""

from __future__ import annotations

import argparse
import json
import logging
import sys

from drep_tpu_torch.argparser import UNPORTED_INDEX_OPS, parse_args
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.utils.logger import get_logger, setup_logger
from drep_tpu_torch.workflows import (
    compare_wrapper,
    dereplicate_wrapper,
    index_build_wrapper,
    index_classify_wrapper,
    index_maintenance_wrapper,
    index_route_wrapper,
    index_serve_wrapper,
    index_update_wrapper,
)


def check_dependencies() -> list[str]:
    """Log (and return) the torch build, the CUDA cards it sees, the nvcc
    that builds the kernels, and then, as the JAX package does, each
    external binary of the subprocess engines and the bonus stage
    (cluster/external.py::EXTERNAL_SUITE) with its path and version."""
    import torch

    from drep_tpu_torch.cluster.external import EXTERNAL_SUITE, find_program
    from drep_tpu_torch.ops import _build

    n = torch.cuda.device_count()
    lines = [f"torch {torch.__version__} (CUDA {torch.version.cuda}); {n} CUDA device(s)"]
    lines += [f"  device {i}: {torch.cuda.get_device_name(i)}" for i in range(n)]
    try:
        lines.append(f"  nvcc {_build.nvcc_path()}")
    except RuntimeError as e:
        lines.append(f"  nvcc NOT FOUND ({e})")
    for name in sorted(EXTERNAL_SUITE):
        path, version = find_program(name)
        if path is None:
            status = "NOT FOUND (subprocess engine unavailable; the CUDA engines unaffected)"
        else:
            status = f"{path}  ({version})" if version else path
        lines.append(f"  external {name:<14} {status}")
    setup_logger(None)
    for line in lines:
        get_logger().info("%s", line)
    return lines


def index_operation(**kwargs):
    """`index build|update|classify|serve|route|split|merge|compact`:
    classify prints one JSON verdict line per query on stdout, as the JAX
    CLI does; the others log their summaries; serve and route block until
    drained (exit 0 is the drain contract). `index supervise` raises
    NotImplementedError naming its ROADMAP item."""
    sub = kwargs.pop("index_op")
    index_loc = kwargs.pop("index_directory")
    if sub in UNPORTED_INDEX_OPS:
        raise NotImplementedError(
            f"index {sub}: not ported yet (ROADMAP.md queue 1, item {UNPORTED_INDEX_OPS[sub]})"
        )
    genomes = kwargs.pop("genomes", None)
    if sub == "build":
        return index_build_wrapper(index_loc, genomes, **kwargs)
    if sub == "update":
        return index_update_wrapper(index_loc, genomes, **kwargs)
    if sub == "serve":
        return index_serve_wrapper(index_loc, **kwargs)
    if sub == "route":
        return index_route_wrapper(index_loc, **kwargs)
    if sub in ("split", "merge", "compact"):
        return index_maintenance_wrapper(index_loc, op=sub, **kwargs)
    if sub == "classify":
        verdicts = index_classify_wrapper(index_loc, genomes, **kwargs)
        for v in verdicts:
            print(json.dumps(v), file=sys.stdout, flush=True)
        return verdicts
    raise ValueError(f"unknown index operation {sub!r}")


def run(args: argparse.Namespace):
    if args.operation == "check_dependencies":
        return check_dependencies()
    kwargs = {k: v for k, v in vars(args).items() if k != "operation"}
    if kwargs.pop("debug", False):
        setup_logger(None, verbosity=logging.DEBUG)
    if args.operation == "index":
        return index_operation(**kwargs)
    wd_loc = kwargs.pop("work_directory")
    genomes = kwargs.pop("genomes", None)
    if args.operation == "compare":
        return compare_wrapper(wd_loc, genomes, **kwargs)
    if args.operation == "dereplicate":
        return dereplicate_wrapper(wd_loc, genomes, **kwargs)
    raise ValueError(f"unknown operation {args.operation!r}")


def main(argv: list[str] | None = None) -> None:
    try:
        run(parse_args(argv))
    except UserInputError as e:
        # user-input errors end as one `!!!` line, not a traceback
        get_logger().error("!!! %s", e)
        sys.exit(1)


if __name__ == "__main__":
    main()
