"""Stage planner: the physical execution plan.

Port of the stage planning of ``nnstreamer_tpu/pipeline/plan.py``.  Every
element is its own stage, with its own runner thread and input queue.
Fusing a chain of device elements into one program is not part of this
package yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..elements.base import Element
from .graph import PipelineGraph


@dataclasses.dataclass
class Stage:
    """One schedulable unit: a single element."""

    element: Element
    node_ids: List[int]


def plan_stages(graph: PipelineGraph, elements: Dict[int, Element]) -> List[Stage]:
    """One stage per node, in topological order."""
    return [Stage(elements[n.id], [n.id]) for n in graph.topo_order()]
