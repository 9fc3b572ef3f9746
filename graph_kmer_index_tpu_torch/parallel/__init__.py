"""Host-side parallelism of the build: the pooled span walk over
critical-path chunks (host_pool) and its subprocess workers (proc_pool)."""
