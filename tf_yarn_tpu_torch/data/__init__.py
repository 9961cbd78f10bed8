"""Input pipeline pieces of the port: `prefetch`, a copy of
tf_yarn_tpu/data/prefetch.py."""
