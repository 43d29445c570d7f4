"""The port's language-model stack, hybrid family so far: layers,
attention (prefill through the flash attention kernel), the Mamba2 mixer
(prefill through the SSD scan kernel) and model assembly."""
