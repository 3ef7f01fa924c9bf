# fugu_tpu server image (reference ships a Dockerfile; parity artifact).
# For a GPU, install JAX with its CUDA plugin ("jax[cuda12]") on a CUDA
# base image instead of the CPU wheel below.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY fugu_tpu ./fugu_tpu
COPY native ./native
COPY README.md ARCHITECTURE.md ./

RUN pip install --no-cache-dir "jax[cpu]" aiohttp pyyaml numpy \
    && python -m fugu_tpu.native --build

ENV FUGU_DATA_PATH=/data
VOLUME /data
EXPOSE 3301

CMD ["python", "-m", "fugu_tpu", "serve", "--port", "3301"]
