"""Top-level controller: parsed args -> workflow (drep_tpu/controller.py:
compare, dereplicate and check_dependencies)."""

from __future__ import annotations

import argparse
import logging
import sys

from drep_tpu_torch.argparser import parse_args
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.utils.logger import get_logger, setup_logger
from drep_tpu_torch.workflows import compare_wrapper, dereplicate_wrapper


def check_dependencies() -> list[str]:
    """Log (and return) the torch build, the CUDA cards it sees and the
    nvcc that builds the kernels. The JAX package also probes the external
    binaries of its subprocess engines, which the port does not run
    (ROADMAP.md queue 1, item 9b)."""
    import torch

    from drep_tpu_torch.ops import _build

    n = torch.cuda.device_count()
    lines = [f"torch {torch.__version__} (CUDA {torch.version.cuda}); {n} CUDA device(s)"]
    lines += [f"  device {i}: {torch.cuda.get_device_name(i)}" for i in range(n)]
    try:
        lines.append(f"  nvcc {_build.nvcc_path()}")
    except RuntimeError as e:
        lines.append(f"  nvcc NOT FOUND ({e})")
    lines.append("  subprocess engines (mash, fastANI, ANImf, ANIn, gANI, goANI): not ported "
                 "(ROADMAP.md queue 1, item 9b)")
    setup_logger(None)
    for line in lines:
        get_logger().info("%s", line)
    return lines


def run(args: argparse.Namespace):
    if args.operation == "check_dependencies":
        return check_dependencies()
    kwargs = {k: v for k, v in vars(args).items() if k != "operation"}
    if kwargs.pop("debug", False):
        setup_logger(None, verbosity=logging.DEBUG)
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
