"""Configurations: the port's own copies of the JAX package's, with the same
values.  The update path's workloads (``go_kge``, ``hp_kge``), the dense
LM archs (``h2o_danube_1_8b``, ``qwen2_72b``, ``mistral_large_123b``,
``internlm2_20b``), the MoE archs (``olmoe_1b_7b``, ``grok_1_314b``), the
SSM, audio and VLM archs (``falcon_mamba_7b``, ``whisper_base``,
``llava_next_34b``; ``CONFIG`` at the published widths, ``REDUCED`` for
the CPU) and the zoo's input shapes (``shapes``)."""
