"""User-input errors, distinguished from internal failures.

The CLI entry reports these as one `!!!` line and exits 1 (the
reference's user-facing-warning convention, SURVEY.md §5.5); anything
else propagates with a full traceback — an internal ValueError deep in
clustering must stay debuggable, not be disguised as a user mistake.
Deliberately dependency-free: ingest pool workers import this module.
"""

from __future__ import annotations


class UserInputError(ValueError):
    """Bad user input: nonexistent paths, non-FASTA files, conflicting
    flag combinations. Message must be self-contained and actionable."""
