"""Analysis of the port without running it on a card: the roofline
(``roofline``), which the dry run (``launch.dryrun``) reports through, and
the invariant lint (``lint``, ``python -m repro_torch.analysis.lint``), a
pure-stdlib AST pass imported on its own."""
from repro_torch.analysis import roofline

__all__ = ["roofline"]
