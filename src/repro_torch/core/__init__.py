"""Core numerics of the port: objective, penalties, graphs, cost model,
the matops dispatch and the proximal-gradient loop."""
