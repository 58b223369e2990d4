"""The runtime's core: ids, options, refs, resources, serialization and the
in-process backend (the port of ray_tpu/core/ that local mode stands on)."""
