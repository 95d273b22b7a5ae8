"""Analysis of the port's steps without running them on a card: the
roofline (``roofline``), which the dry run (``launch.dryrun``) reports
through."""
from repro_torch.analysis import roofline

__all__ = ["roofline"]
