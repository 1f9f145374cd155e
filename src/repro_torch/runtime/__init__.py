"""The port's runtime: failure injection and restart policy, straggler
detection, the §6 closed control loop over a fault-injecting cluster
simulator, and the elastic move of a training state between meshes
(counterparts of the JAX package's ``repro/runtime`` modules)."""
