"""Test-support task: spin until killed (exercises the KILLED status path
of the backends without a real long training job) — a copy of
tf_yarn_tpu/tasks/_spin.py. TPU_YARN_SPIN_SECS overrides the duration
(0 = exit immediately)."""

import os
import time

if __name__ == "__main__":
    time.sleep(float(os.environ.get("TPU_YARN_SPIN_SECS", "120")))
