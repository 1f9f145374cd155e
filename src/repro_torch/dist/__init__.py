"""Placement on a device mesh: logical axes -> specs (``partitioning``), the
axes-tree walkers (``treeutil``) and the serve and training data planes'
collectives (``collectives``)."""
