"""Placement on a device mesh: logical axes -> specs (``partitioning``), the
axes-tree walkers (``treeutil``) and the serve data plane's collectives
(``collectives``)."""
