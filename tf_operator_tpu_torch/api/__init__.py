"""The operator's API vocabulary that the port's workers read: the port's
own copy of the names it needs from tf_operator_tpu/api/types.py."""
