"""The port's LM: dense GQA decoder layers, their serving entry points, and
the runtime options that pick kernel geometry."""
