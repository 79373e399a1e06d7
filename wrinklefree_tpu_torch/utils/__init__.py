"""Host utilities: the kernels' build cache and the compile watcher
(``torchcache``)."""
