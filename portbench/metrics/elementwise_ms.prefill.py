"""Device ms a prefill request in torch's elementwise kernels, copies and
reductions: the MoE dispatch and combine, rotary positions, the residuals."""


def read(w):
    return w.ms_per_step("elementwise, copies and reductions")
