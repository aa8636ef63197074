from setuptools import setup, find_packages

with open("ml_stable_diffusion_tpu/_version.py") as f:
    exec(f.read())

setup(
    name="ml-stable-diffusion-tpu",
    version=__version__,  # noqa: F821
    description="TPU-native Stable Diffusion framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["ml_stable_diffusion_tpu*", "ml_stable_diffusion_torch*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "numpy",
        "einops",
        "safetensors",
        "pillow",
    ],
    extras_require={
        "convert": ["torch", "transformers"],
        "test": ["pytest", "torch", "transformers"],
    },
    entry_points={
        "console_scripts": [
            "sdtpu-generate=ml_stable_diffusion_tpu.cli.generate:main",
            "sdtpu-convert=ml_stable_diffusion_tpu.cli.convert:main",
            "sdtpu-benchmark=ml_stable_diffusion_tpu.cli.benchmark:main",
            "sdtpu-compress=ml_stable_diffusion_tpu.cli.compress:main",
            "sdtorch-generate=ml_stable_diffusion_torch.cli.generate:main",
            "sdtorch-convert=ml_stable_diffusion_torch.cli.convert:main",
            "sdtorch-benchmark=ml_stable_diffusion_torch.cli.benchmark:main",
            "sdtorch-compress=ml_stable_diffusion_torch.cli.compress:main",
        ]
    },
)
