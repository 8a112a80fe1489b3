"""Device ops: murmur grouping, count-min sketch, top-K table, EWMA and
quantile sketch, and the CUDA wrappers of the two CMS updates."""
