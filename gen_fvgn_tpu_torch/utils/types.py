"""Node / face type codes shared by the ETL and the device pipeline.

Parity: reference `src/utils/utilities.py:7-13` (NodeType enum). Values are part
of the on-disk .h5 contract, so they must match the reference exactly.
"""

import enum


class NodeType(enum.IntEnum):
    NORMAL = 0
    INFLOW = 1
    OUTFLOW = 2
    WALL_BOUNDARY = 3
    PRESS_POINT = 4
    IN_WALL = 5


# Node types whose velocity is pinned by a Dirichlet condition during training.
# Parity: reference `src/FVMmodel/importer.py:141-154`.
DIRICHLET_TYPES = (
    NodeType.WALL_BOUNDARY,
    NodeType.INFLOW,
    NodeType.PRESS_POINT,
    NodeType.IN_WALL,
)

# Any boundary type (used for face classification / stencil construction).
BOUNDARY_TYPES = (
    NodeType.INFLOW,
    NodeType.OUTFLOW,
    NodeType.WALL_BOUNDARY,
    NodeType.PRESS_POINT,
    NodeType.IN_WALL,
)
