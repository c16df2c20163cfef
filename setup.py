from setuptools import find_packages, setup

setup(
    name="aps_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) speech processing toolkit "
                "with the capability surface of funcwj/aps",
    packages=find_packages(include=["aps_tpu", "aps_tpu.*", "aps_tpu_torch",
                                    "aps_tpu_torch.*"]),
    package_data={"aps_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
)
