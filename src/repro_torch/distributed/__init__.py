"""The distributed layer: so far only the mesh-free re-mesh planner
(:mod:`.elastic`)."""
