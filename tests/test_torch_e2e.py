"""The operator launches the port's workers: the twins of
tests/test_e2e.py's TestMultiProcessRendezvous and
TestDistributedTraining with the port's workloads in the pods.

The JAX package's controller, InMemorySubstrate and ProcessKubelet run a
TPU-type TFJob of two pods as real local processes, with the
operator-injected identity env (TPU_WORKER_ID, TPU_WORKER_HOSTNAMES,
JAX_NUM_PROCESSES, JAX_PROCESS_ID) and TFJOB_COORDINATOR_OVERRIDE mapping
the coordinator to 127.0.0.1. The pods run the port's
testing/rendezvous_worker.py, then train/mnist.py, with `--device cpu`
(the kubelet sets JAX_PLATFORMS=cpu, which the port does not read). A
TPU-type job succeeds only when both pods exit 0. As in the reference's
tests, a coordinator port taken between the pick and the bind is retried
once with a fresh port and job.
"""

import json
import sys

from tf_operator_tpu.api import k8s
from tf_operator_tpu.api import types as t
from tf_operator_tpu.runtime.process_kubelet import free_port

from tests.test_api import make_job
from tests.test_e2e import live_cluster, retry_flaky, wait_until

# two processes share the machine: two threads each
THREADS = "2"


def _run_job(name, argv, timeout):
    """Run a two-pod TPU job of `argv` to its end; its pods' logs by index."""
    with live_cluster(wait_ready=False) as parts:
        _, _, _, client = parts
        job = make_job({"TPU": 2}, name=name)
        job.spec.run_policy.clean_pod_policy = t.CleanPodPolicy.NONE
        container = job.spec.tf_replica_specs["TPU"].template.spec.containers[0]
        container.command = [sys.executable, "-m"] + argv
        container.env.append(k8s.EnvVar(
            name="TFJOB_COORDINATOR_OVERRIDE", value=f"127.0.0.1:{free_port()}"))
        container.env.append(k8s.EnvVar(name="OMP_NUM_THREADS", value=THREADS))
        client.create(job)
        wait_until(lambda: client.get(name).is_finished(), timeout=timeout,
                   message=f"{name} finished")
        logs = client.get_logs(name, master=False, replica_type="tpu")
        assert client.is_job_succeeded(name), (client.get(name).status, logs)
        assert set(logs) == {f"{name}-tpu-0", f"{name}-tpu-1"}
        return {int(pod.rsplit("-", 1)[1]): text for pod, text in logs.items()}


class TestPortRendezvous:
    """Each pod of the port checks its place in the world from inside."""

    def test_port_workers_verify_world_from_inside(self):
        retry_flaky(lambda attempt: self._run(f"trdv{attempt}"))

    def _run(self, name):
        logs = _run_job(name, [
            "tf_operator_tpu_torch.testing.rendezvous_worker", "--device", "cpu"], timeout=120)
        for index, text in logs.items():
            assert f"process {index}/2" in text, text
            lines = [line for line in text.splitlines() if line.startswith("RENDEZVOUS ")]
            assert lines, f"no rendezvous report from pod {index}: {text!r}"
            report = json.loads(lines[-1].split(" ", 1)[1])
            assert report["ok"], report
            assert report["process_index"] == index
            assert report["process_count"] == 2
            assert report["gathered_world"] == [0, 1]
            assert report["backend"] == "gloo"
            assert report["hostnames"] == [
                f"{name}-tpu-0.default.svc", f"{name}-tpu-1.default.svc"]


class TestPortDistributedTraining:
    """The port's MNIST CLI trains across the two pods: DDP over gloo, the
    gradient all-reduce crossing the process boundary."""

    def test_port_mnist_trains_across_two_worker_processes(self):
        retry_flaky(lambda attempt: self._run(f"tdtrain{attempt}"))

    def _run(self, name):
        logs = _run_job(name, [
            "tf_operator_tpu_torch.train.mnist", "--device", "cpu", "--steps", "4",
            "--batch-size", "64", "--log-every", "2"], timeout=240)
        accuracies = set()
        for index, text in logs.items():
            assert f"process {index}/2" in text, text
            assert "mesh: dp=2xpp=1xfsdp=1xep=1xsp=1xtp=1" in text, text
            assert "step 4 loss=" in text, text
            lines = [line for line in text.splitlines() if "held-out eval accuracy" in line]
            assert lines, text
            accuracies.add(lines[-1].split("held-out eval accuracy: ")[1].split(" ")[0])
        # the eval runs over both ranks' rows: every rank logs the same number
        assert len(accuracies) == 1, accuracies
