"""Runtime plumbing the port copies from tf_operator_tpu/runtime/."""
