"""Device ops: murmur grouping, count-min sketch, top-K table, and the
CUDA wrapper of the conservative CMS update."""
