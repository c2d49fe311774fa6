"""Top-level controller: parsed args -> workflow (drep_tpu/controller.py,
compare and dereplicate)."""

from __future__ import annotations

import argparse
import logging
import sys

from drep_tpu_torch.argparser import parse_args
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.utils.logger import get_logger, setup_logger
from drep_tpu_torch.workflows import compare_wrapper, dereplicate_wrapper


def run(args: argparse.Namespace):
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
