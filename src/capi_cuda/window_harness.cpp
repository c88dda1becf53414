/*!
 * The fork's retrain-every-window loop through the native LGBM_* ABI at
 * full width (the cache-admission harness, src/test.cpp:243-298 in the
 * reference; examples/cache_admission.py in Python): compiled against the
 * unchanged include/lightgbm_tpu/c_api.h and linked to
 * liblgbm_tpu_torch.so.
 *
 *   window_harness <dir> <windows> [key=value ...]
 *
 * <dir> holds each window k (0 .. windows-1) as raw little-endian arrays:
 * w<k>_indptr.i64, w<k>_indices.i32, w<k>_data.f32 (CSR, zeros dropped)
 * and w<k>_label.f32.  The fork's parameters (50 iterations, 31 leaves,
 * max_bin 255, feature_fraction 0.8, bagging 5/0.8, min_data_in_leaf 50,
 * min_sum_hessian_in_leaf 5.0), trained in chunks of 25, take the extra
 * key=value arguments on top (device=cpu, grower_cache=false, ...).
 *
 * First LGBM_WarmupTrain and LGBM_WarmupServe; then for each training
 * window w < windows-1: DatasetCreateFromCSR (window 0's dataset is the
 * reference of every later one), SetField, BoosterCreate,
 * BoosterUpdateChunked, ServeCreate or ServeSwap, BoosterPredictForCSR
 * and ServePredictForCSR of window w+1 (written to <dir>/pred_w<w>.f64
 * and <dir>/serve_w<w>.f64), serve latency at 1 and 100,000 rows,
 * BoosterSaveModel (<dir>/model_w<w>.txt), on the last window a
 * two-tenant fleet created, swapped and scored against the server, and
 * BoosterFree of the window's booster (the server serves its own copy of
 * the model, and the booster's grower waits in the grower cache for the
 * next window's).  Each window prints one line
 * "WINDOW {json}"; with LGBM_TPU_METRICS set, the metrics file is copied
 * to <dir>/metrics_w<w>.json after each window.  Exit 0 = pass.
 */
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "../../include/lightgbm_tpu/c_api.h"

namespace {

const int kCols = 53;
const int kIterations = 50;
const int kChunk = 25;

std::unordered_map<std::string, std::string> train_params() {
  return {{"boosting", "gbdt"},          {"objective", "binary"},
          {"max_bin", "255"},            {"num_iterations", "50"},
          {"learning_rate", "0.1"},      {"num_leaves", "31"},
          {"tree_learner", "serial"},    {"feature_fraction", "0.8"},
          {"bagging_freq", "5"},         {"bagging_fraction", "0.8"},
          {"min_data_in_leaf", "50"},    {"min_sum_hessian_in_leaf", "5.0"},
          {"fused_chunk", "25"},         {"verbosity", "-1"}};
}

void check(int rc, const char* what) {
  if (rc != 0) {
    std::fprintf(stderr, "FAIL %s: %s\n", what, LGBM_GetLastError());
    std::exit(1);
  }
}

template <typename T>
std::vector<T> read_file(const std::string& path) {
  std::ifstream in(path, std::ios::binary | std::ios::ate);
  if (!in) {
    std::fprintf(stderr, "FAIL cannot read %s\n", path.c_str());
    std::exit(1);
  }
  const std::streamsize bytes = in.tellg();
  in.seekg(0);
  std::vector<T> out(static_cast<size_t>(bytes) / sizeof(T));
  in.read(reinterpret_cast<char*>(out.data()), bytes);
  return out;
}

void write_file(const std::string& path, const std::vector<double>& v) {
  std::ofstream out(path, std::ios::binary);
  out.write(reinterpret_cast<const char*>(v.data()),
            static_cast<std::streamsize>(v.size() * sizeof(double)));
}

struct Window {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<float> data;
  std::vector<float> label;
  int64_t rows() const { return static_cast<int64_t>(indptr.size()) - 1; }
};

Window load_window(const std::string& dir, int k) {
  const std::string p = dir + "/w" + std::to_string(k) + "_";
  Window w;
  w.indptr = read_file<int64_t>(p + "indptr.i64");
  w.indices = read_file<int32_t>(p + "indices.i32");
  w.data = read_file<float>(p + "data.f32");
  w.label = read_file<float>(p + "label.f32");
  return w;
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

/* rows [a, b) of a window as CSR arguments */
struct Slice {
  std::vector<int64_t> indptr;
  const int32_t* indices;
  const float* data;
  int64_t nelem;
};

Slice slice(const Window& w, int64_t a, int64_t b) {
  Slice s;
  s.indptr.resize(b - a + 1);
  for (int64_t i = a; i <= b; i++) s.indptr[i - a] = w.indptr[i] - w.indptr[a];
  s.indices = w.indices.data() + w.indptr[a];
  s.data = w.data.data() + w.indptr[a];
  s.nelem = w.indptr[b] - w.indptr[a];
  return s;
}

int serve_predict(ServeHandle server, const Slice& s, std::vector<double>* out,
                  int64_t* len) {
  return LGBM_ServePredictForCSR(
      server, s.indptr.data(), C_API_DTYPE_INT64, s.indices, s.data,
      C_API_DTYPE_FLOAT32, static_cast<int64_t>(s.indptr.size()), s.nelem,
      kCols, C_API_PREDICT_NORMAL, len, out->data());
}

/* median milliseconds of `reps` ServePredictForCSR calls of `rows` rows */
double serve_p50_ms(ServeHandle server, const Window& w, int64_t rows,
                    int reps) {
  std::vector<double> times;
  std::vector<double> out(rows);
  for (int r = 0; r < reps; r++) {
    const int64_t a = (r * 7919 * rows) % std::max<int64_t>(w.rows() - rows, 1);
    Slice s = slice(w, a, a + rows);
    int64_t len = 0;
    auto t0 = std::chrono::steady_clock::now();
    check(serve_predict(server, s, &out, &len), "ServePredictForCSR(p50)");
    times.push_back(seconds_since(t0) * 1e3);
  }
  std::sort(times.begin(), times.end());
  return times[times.size() / 2];
}

void copy_file(const std::string& from, const std::string& to) {
  std::ifstream in(from, std::ios::binary);
  if (!in) return;
  std::ofstream out(to, std::ios::binary);
  out << in.rdbuf();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: window_harness <dir> <windows> "
                         "[key=value ...]\n");
    return 2;
  }
  const std::string dir = argv[1];
  const int windows = std::atoi(argv[2]);
  auto params = train_params();
  for (int i = 3; i < argc; i++) {
    const std::string kv = argv[i];
    const size_t eq = kv.find('=');
    if (eq != std::string::npos) params[kv.substr(0, eq)] = kv.substr(eq + 1);
  }
  const int iterations = std::atoi(params["num_iterations"].c_str());
  const char* metrics = std::getenv("LGBM_TPU_METRICS");

  std::vector<Window> data;
  for (int k = 0; k < windows; k++) data.push_back(load_window(dir, k));
  const int64_t rows = data[0].rows();

  auto t0 = std::chrono::steady_clock::now();
  int warm_train = -1, warm_serve = -1;
  check(LGBM_WarmupTrain(params, rows, kCols, &warm_train), "WarmupTrain");
  const double warm_train_s = seconds_since(t0);
  t0 = std::chrono::steady_clock::now();
  check(LGBM_WarmupServe(params, 100000, kCols, &warm_serve), "WarmupServe");
  std::printf("WARMUP {\"train_built\": %d, \"train_s\": %.6f, "
              "\"serve_built\": %d, \"serve_s\": %.6f}\n",
              warm_train, warm_train_s, warm_serve, seconds_since(t0));
  std::fflush(stdout);

  DatasetHandle reference = nullptr;
  ServeHandle server = nullptr;
  for (int w = 0; w + 1 < windows; w++) {
    const Window& win = data[w];
    const Window& next = data[w + 1];
    auto t = std::chrono::steady_clock::now();
    DatasetHandle ds = nullptr;
    check(LGBM_DatasetCreateFromCSR(
              win.indptr.data(), C_API_DTYPE_INT64, win.indices.data(),
              win.data.data(), C_API_DTYPE_FLOAT32,
              static_cast<int64_t>(win.indptr.size()),
              static_cast<int64_t>(win.data.size()), kCols, params, reference,
              &ds),
          "DatasetCreateFromCSR");
    check(LGBM_DatasetSetField(ds, "label", win.label.data(),
                               static_cast<int>(win.label.size()),
                               C_API_DTYPE_FLOAT32),
          "DatasetSetField");
    const double dataset_s = seconds_since(t);

    t = std::chrono::steady_clock::now();
    BoosterHandle target = nullptr;
    check(LGBM_BoosterCreate(ds, params, &target), "BoosterCreate");
    const double create_s = seconds_since(t);
    t = std::chrono::steady_clock::now();
    int finished = 0;
    check(LGBM_BoosterUpdateChunked(target, iterations, kChunk, &finished),
          "BoosterUpdateChunked");
    int64_t iters = 0;
    check(LGBM_BoosterGetCurrentIteration(target, &iters),
          "GetCurrentIteration");
    const double train_s = seconds_since(t);

    t = std::chrono::steady_clock::now();
    if (server == nullptr) {
      check(LGBM_ServeCreate(target, params, &server), "ServeCreate");
    } else {
      check(LGBM_ServeSwap(server, target), "ServeSwap");
    }
    const double swap_s = seconds_since(t);
    BoosterHandle booster = target;

    const int64_t n = next.rows();
    int64_t len = 0;
    check(LGBM_BoosterCalcNumPredict(booster, static_cast<int>(n),
                                     C_API_PREDICT_NORMAL, -1, &len),
          "CalcNumPredict");
    std::vector<double> pred(len);
    t = std::chrono::steady_clock::now();
    check(LGBM_BoosterPredictForCSR(
              booster, next.indptr.data(), C_API_DTYPE_INT64,
              next.indices.data(), next.data.data(), C_API_DTYPE_FLOAT32,
              static_cast<int64_t>(next.indptr.size()),
              static_cast<int64_t>(next.data.size()), kCols,
              C_API_PREDICT_NORMAL, -1, params, &len, pred.data()),
          "BoosterPredictForCSR");
    const double predict_s = seconds_since(t);
    std::vector<double> served(n);
    t = std::chrono::steady_clock::now();
    int64_t slen = 0;
    check(serve_predict(server, slice(next, 0, n), &served, &slen),
          "ServePredictForCSR");
    const double serve_s = seconds_since(t);
    if (len != n || slen != n) {
      std::fprintf(stderr, "FAIL prediction lengths %lld/%lld != %lld\n",
                   static_cast<long long>(len), static_cast<long long>(slen),
                   static_cast<long long>(n));
      return 1;
    }
    for (int64_t i = 0; i < n; i++) {
      if (!(pred[i] >= 0.0 && pred[i] <= 1.0)) {
        std::fprintf(stderr, "FAIL prob out of range at %lld: %f\n",
                     static_cast<long long>(i), pred[i]);
        return 1;
      }
    }
    write_file(dir + "/pred_w" + std::to_string(w) + ".f64", pred);
    write_file(dir + "/serve_w" + std::to_string(w) + ".f64", served);
    const double p50_1 = serve_p50_ms(server, next, 1, 41);
    const int64_t big = std::min<int64_t>(100000, n);
    const double p50_big = serve_p50_ms(server, next, big, 7);
    check(LGBM_BoosterSaveModel(
              booster, 0, -1,
              (dir + "/model_w" + std::to_string(w) + ".txt").c_str()),
          "BoosterSaveModel");

    double fleet_err = -1.0;
    if (w + 2 == windows) {
      FleetHandle fleet = nullptr;
      check(LGBM_FleetCreate(booster, 2, params, &fleet), "FleetCreate");
      check(LGBM_FleetSwapTenant(fleet, 1, booster), "FleetSwapTenant");
      std::vector<int32_t> tenants(big);
      for (int64_t i = 0; i < big; i++) tenants[i] = static_cast<int32_t>(i % 2);
      int64_t flen = 0;
      check(LGBM_FleetCalcNumPredict(fleet, static_cast<int>(big), &flen),
            "FleetCalcNumPredict");
      std::vector<double> fout(flen);
      Slice s = slice(next, 0, big);
      check(LGBM_FleetPredictForCSR(
                fleet, tenants.data(), big, s.indptr.data(),
                C_API_DTYPE_INT64, s.indices, s.data, C_API_DTYPE_FLOAT32,
                static_cast<int64_t>(s.indptr.size()), s.nelem, kCols,
                C_API_PREDICT_NORMAL, &flen, fout.data()),
            "FleetPredictForCSR");
      fleet_err = 0.0;
      for (int64_t i = 0; i < big; i++) {
        fleet_err = std::max(fleet_err, std::fabs(fout[i] - served[i]));
      }
      check(LGBM_FleetFree(fleet), "FleetFree");
      if (fleet_err > 1e-12) {
        std::fprintf(stderr, "FAIL fleet/serve differ by %g\n", fleet_err);
        return 1;
      }
    }
    /* the server keeps its own packed copy: the window's booster is
     * freed here, and its grower waits idle for the next window's */
    check(LGBM_BoosterFree(booster), "BoosterFree");
    if (w > 0) check(LGBM_DatasetFree(ds), "DatasetFree");
    else reference = ds;
    std::printf(
        "WINDOW {\"window\": %d, \"rows\": %lld, \"dataset_s\": %.6f, "
        "\"booster_create_s\": %.6f, \"train_s\": %.6f, \"iterations\": "
        "%lld, \"finished\": %d, \"swap_s\": %.6f, \"predict_s\": %.6f, "
        "\"serve_predict_s\": %.6f, \"serve_p50_ms_1\": %.6f, "
        "\"serve_big_rows\": %lld, \"serve_p50_ms_big\": %.6f, "
        "\"fleet_max_err\": %g}\n",
        w, static_cast<long long>(win.rows()), dataset_s, create_s, train_s,
        static_cast<long long>(iters), finished, swap_s, predict_s, serve_s,
        p50_1, static_cast<long long>(big), p50_big, fleet_err);
    std::fflush(stdout);
    if (metrics != nullptr && metrics[0] != '\0') {
      copy_file(metrics, dir + "/metrics_w" + std::to_string(w) + ".json");
    }
  }
  check(LGBM_ServeFree(server), "ServeFree");
  check(LGBM_DatasetFree(reference), "DatasetFree(reference)");
  std::printf("window harness: PASS\n");
  return 0;
}
