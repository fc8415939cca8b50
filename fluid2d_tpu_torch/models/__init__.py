"""Time-step models: the CIP step and the simulator façade."""
