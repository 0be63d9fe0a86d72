// K11's warpgroup MMAs (csrc/ntt_mxu.cu): one function a width N = 8L of
// wgmma.mma_async.m64nNk32.s32.u8.u8 with both operands in shared memory,
// for the widths the product issues (L = 1..4 and the even L up to 32: the
// N that u8 wgmma takes).  d is the first of L accumulator slots of four
// registers each; an asm template must name every register, so each width
// is written out; tests/test_torch_ntt_mxu.py checks each against the one
// pattern.

#pragma once
#include <stdint.h>

namespace mxu {

template <int L>
__device__ __forceinline__ void wgmma_ss(uint32_t (*d)[4], uint64_t a, uint64_t b);

#define MXU_D4(i) "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])

template <>
__device__ __forceinline__ void wgmma_ss<1>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}"
      : MXU_D4(0)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<2>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}"
      : MXU_D4(0), MXU_D4(1)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<3>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<4>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<6>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<8>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<10>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<12>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<14>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %58, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n112k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<18>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %74, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n144k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<20>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n160k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<22>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %90, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n176k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, %88, %89, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<24>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21), MXU_D4(22), MXU_D4(23)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<26>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %106, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n208k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21), MXU_D4(22), MXU_D4(23),
        MXU_D4(24), MXU_D4(25)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<28>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %114, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n224k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21), MXU_D4(22), MXU_D4(23),
        MXU_D4(24), MXU_D4(25), MXU_D4(26), MXU_D4(27)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<30>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %122, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n240k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21), MXU_D4(22), MXU_D4(23),
        MXU_D4(24), MXU_D4(25), MXU_D4(26), MXU_D4(27), MXU_D4(28), MXU_D4(29)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(uint32_t (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}"
      : MXU_D4(0), MXU_D4(1), MXU_D4(2), MXU_D4(3), MXU_D4(4), MXU_D4(5),
        MXU_D4(6), MXU_D4(7), MXU_D4(8), MXU_D4(9), MXU_D4(10), MXU_D4(11),
        MXU_D4(12), MXU_D4(13), MXU_D4(14), MXU_D4(15), MXU_D4(16), MXU_D4(17),
        MXU_D4(18), MXU_D4(19), MXU_D4(20), MXU_D4(21), MXU_D4(22), MXU_D4(23),
        MXU_D4(24), MXU_D4(25), MXU_D4(26), MXU_D4(27), MXU_D4(28), MXU_D4(29),
        MXU_D4(30), MXU_D4(31)
      : "l"(a), "l"(b), "r"(1));
}

#undef MXU_D4

}  // namespace mxu
