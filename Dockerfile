# Runtime image for gpras-tpu pipelines (host-side; attach a GPU via your
# platform's container runtime). The native geometry engine builds at first use, so g++
# stays in the image.
FROM python:3.12-slim AS runtime

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/gpras-tpu
COPY pyproject.toml README.md ./
COPY gpras_tpu ./gpras_tpu
RUN pip install --no-cache-dir ".[dev]"

ENTRYPOINT ["python", "-m", "gpras_tpu"]

# Dev stage for the devcontainer (reference parity: the reference ships a
# devcontainer whose image carries the HEC-DSS native stack,
# /root/reference/.devcontainer/devcontainer.json:36-38, Dockerfile:9-13).
# Adds git + the dss/s3 extras (hecdss wheels bundle the Fortran/C library;
# the install is best-effort — gpras_tpu.data.dss gates cleanly when absent)
# and pre-commit for the hook workflow.
FROM runtime AS dev
RUN apt-get update && apt-get install -y --no-install-recommends \
    git \
    && rm -rf /var/lib/apt/lists/*
RUN pip install --no-cache-dir pre-commit && \
    pip install --no-cache-dir ".[dss,s3]" || \
    echo "hecdss/boto3 unavailable; DSS and S3 paths stay gated"
ENTRYPOINT []
CMD ["bash"]
