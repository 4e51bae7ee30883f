"""The paper's analytic NVLLM model — the port of ``repro/simulator``:
``hw`` (Table 2–3 constants, ``NVLLMConfig``, the NAND read time),
``system`` (``NVLLMSystem``: decode, prefill, end-to-end time and
movement energy with Algorithm 2's bitmap relaxation) and ``baselines``
(GPU-SSD, GPU-DRAM, Cambricon-LLM, AiF, AiF−−). Pure Python over
``configs.base.ArchConfig``, module for module; nothing of the reference
package is left out. The page store takes its NAND constants from
``hw`` (``store/nand.py``), as the reference's store does.
"""
