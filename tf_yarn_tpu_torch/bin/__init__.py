"""Console scripts of the port: `check_gpu_env`."""
