// A CUDA device for fake tensors on a CPU-only build of PyTorch.
//
// The dry run (launch/dryrun.py) traces one rank's program on FakeTensorMode
// tensors on device "cuda", so that the routes the card takes are the routes
// traced.  A CPU-only build has no CUDA device guard and no CUDA hooks, and
// PyTorch's Python indexing and its autograd engine refuse such a tensor
// without them.  This library registers both for one device:
//
//  * a device guard that holds no state (device 0, the default stream, no
//    events);
//  * CUDA hooks that report CUDA built and available to ATen's accelerator
//    queries (the autograd engine asks for the accelerator's current stream)
//    and initialize nothing.
//
// Nothing here allocates memory or runs work on a device.  ATen reads its
// hooks once, at the first query, which importing torch makes: load this
// library before torch (launch/fake.py::prepare_host).
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>

namespace {

using c10::Device;
using c10::DeviceIndex;
using c10::DeviceType;
using c10::Stream;

struct FakeCudaGuard final : c10::impl::DeviceGuardImplInterface {
  DeviceType type() const override { return DeviceType::CUDA; }
  Device exchangeDevice(Device) const override { return getDevice(); }
  Device getDevice() const override { return Device(DeviceType::CUDA, 0); }
  void setDevice(Device) const override {}
  void uncheckedSetDevice(Device) const noexcept override {}
  Stream getStream(Device d) const noexcept override {
    return Stream(Stream::DEFAULT, d);
  }
  Stream exchangeStream(Stream s) const noexcept override { return s; }
  DeviceIndex deviceCount() const noexcept override { return 1; }
  void record(void**, const Stream&, const DeviceIndex,
              const c10::EventFlag) const override {}
  void block(void*, const Stream&) const override {}
  bool queryEvent(void*) const override { return true; }
  void destroyEvent(void*, const DeviceIndex) const noexcept override {}
};

struct FakeCudaHooks final : at::CUDAHooksInterface {
  explicit FakeCudaHooks(at::CUDAHooksArgs) {}
  void init() const override {}
  bool isBuilt() const override { return true; }
  bool isAvailable() const override { return true; }
  bool hasCUDA() const override { return true; }
  bool hasPrimaryContext(DeviceIndex) const override { return false; }
  int getNumGPUs() const override { return 1; }
  DeviceIndex deviceCount() const override { return 1; }
  DeviceIndex current_device() const override { return 0; }
  DeviceIndex getCurrentDevice() const override { return 0; }
};

FakeCudaGuard guard;

}  // namespace

namespace at {
C10_REGISTER_TYPED_CLASS(CUDAHooksRegistry, "CUDAHooks", FakeCudaHooks);
}

// Registers the guard where the build has none; returns 1 if it did.
extern "C" int repro_register_fake_cuda() {
  if (c10::impl::hasDeviceGuardImpl(DeviceType::CUDA)) return 0;
  static c10::impl::DeviceGuardImplRegistrar registrar(DeviceType::CUDA,
                                                       &guard);
  return 1;
}
