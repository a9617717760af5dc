"""Two-process examples: a planner process serving MPPIisaacPlanner over TCP
and a world process stepping a 1-env Simulation against it."""
