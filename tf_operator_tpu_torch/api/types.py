"""The environment the operator injects into a TPU replica's pods
(controller/cluster_spec.py set_tpu_env), as the worker bootstrap
(parallel/distributed.py) reads it. A copy of the names in
tf_operator_tpu/api/types.py, not an import of them."""

ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_ACCELERATOR = "TPU_ACCELERATOR_TYPE"
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
# remaps ONLY the coordinator endpoint (the identity env stays
# authoritative): hermetic E2Es and local runs rendezvous over 127.0.0.1,
# where the injected headless-service DNS name does not resolve
ENV_COORDINATOR_OVERRIDE = "TFJOB_COORDINATOR_OVERRIDE"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
