"""The port's runtime: failure injection and restart policy, straggler
detection, and the §6 closed control loop over a fault-injecting cluster
simulator (copies of the JAX package's ``repro/runtime`` modules)."""
