"""The yml-driven pipelines: `python -m wavemamba_torch.pipelines.train -opt
<yml>` and `python -m wavemamba_torch.pipelines.test -opt <yml>`. The
counterparts of `wavemamba_tpu/pipelines/`."""
