from setuptools import setup, find_packages

setup(
    name="ray-tpu",
    version="0.1.0",
    description="TPU-native distributed AI runtime",
    packages=find_packages(include=["ray_tpu", "ray_tpu.*",
                                    "ray_tpu_torch", "ray_tpu_torch.*"]),
    package_data={"ray_tpu_torch": ["ops/csrc/*.cu", "ops/csrc/*.cuh",
                                    "_native/ring.cc"]},
    python_requires=">=3.10",
    entry_points={"console_scripts": [
        "ray-tpu=ray_tpu.scripts.cli:main",
        "ray-tpu-torch=ray_tpu_torch.scripts.cli:main"]},
)
