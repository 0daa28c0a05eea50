from setuptools import find_packages, setup

setup(
    name="moshi-tpu",
    version="0.1.0",
    description=("TPU-native streaming speech inference: Mimi codec + "
                 "Moshi dual-transformer LM in JAX/XLA/Pallas"),
    # moshi_tpu (JAX) and moshi_tpu_torch (the PyTorch/CUDA port)
    packages=find_packages(include=["moshi_tpu*"]),
    package_data={"moshi_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    entry_points={
        "console_scripts": [
            "mimi-encode=moshi_tpu.tools.mimi_encode:main",
            "mimi-decode=moshi_tpu.tools.mimi_decode:main",
            "mimi-play=moshi_tpu.tools.mimi_play:main",
            "moshi-tts=moshi_tpu.tools.moshi_tts:main",
            "moshi-stt=moshi_tpu.tools.moshi_stt:main",
            "moshi-sts=moshi_tpu.tools.moshi_sts:main",
            "personaplex=moshi_tpu.tools.personaplex:main",
            "moshi-dl=moshi_tpu.tools.moshi_dl:main",
        ]
    },
)
