# Runtime image (reference-parity: .docker/Dockerfile builds Ubuntu 22.04
# + GiNaC + CPLEX for the C++ stack; here the stack is JAX, so the image
# is Python + the CUDA build of JAX + the native QP oracle). Run it with
# the NVIDIA container runtime (docker run --gpus all ...); the jax[cuda12]
# wheels bring their own CUDA libraries and need only the host driver.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/mpc-cbf-tpu
COPY . .

RUN pip install --no-cache-dir "jax[cuda12]" numpy scipy matplotlib pytest

RUN make -C native

ENV PYTHONPATH=/opt/mpc-cbf-tpu
CMD ["python", "chip_smoke.py"]
