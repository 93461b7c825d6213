"""The distributed layer: the sharding rules of the mesh layouts
(:mod:`.sharding`) and the mesh-free re-mesh planner (:mod:`.elastic`)."""
