"""One module per covariance function of the reference, found by the
configuration's ``gp.kernel``. Each is stationary in the scaled distance
r = ‖(x − x')/ℓ‖ and has:

* ``value(d2, outputscale)``: k from r² = ``d2``;
* ``value_and_slope(d2, outputscale)``: k and ∂k/∂(r²);
* ``spectral(m, d, generator, device)``: ``m`` frequencies of the kernel's
  spectral density at unit lengthscale, (m, d), for random Fourier
  features."""
